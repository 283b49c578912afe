"""PyTorch/CUDA port of ``repro``: the N-body Hermite-6 simulation on an
NVIDIA H100.

Module paths mirror ``repro``'s one for one, so each module here names the
reference module it is held against.  The package imports ``torch``,
``numpy`` and the standard library only.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; below them, every function
follows the device of the tensors it is given.
"""
