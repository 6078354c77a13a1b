from .images import encode_png_base64

__all__ = ["encode_png_base64"]
