"""Kernel F: the flash-attention forward (``flash.py``) and its wrapper
with the reference's shape-adaptive blocks (``ops.py``)."""
