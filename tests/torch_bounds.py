"""Shared by the port's parity tests (tests/test_torch_*.py): a comparison
records the error it measured beside its bound, then asserts the bound.

The values land in each test's JUnit properties, so

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py --junitxml=parity.xml

lists every measured error with its bound. Not collected by pytest.
"""

import operator

_OPS = {"<": operator.lt, "<=": operator.le, ">=": operator.ge}


def bounded(record_property, name: str, value, op: str, bound: float) -> float:
    """Record ``name`` = ``value`` and its bound, then assert
    ``value <op> bound``. Returns the value."""
    value = float(value)
    record_property(name, value)
    record_property(f"{name} bound", f"{op} {bound}")
    assert _OPS[op](value, bound), f"{name} = {value}, bound {op} {bound}"
    return value
