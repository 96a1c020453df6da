from . import fields, fused_push, interp, push  # noqa: F401
