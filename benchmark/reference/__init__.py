"""Plain references that decide ``correct``. They import nothing of the
measured package and take nothing it made."""
