"""cvpce_tpu_torch — the PyTorch/CUDA port of cvpce_tpu for NVIDIA Hopper.

Module tree mirrors `cvpce_tpu/`: `models/gln.py` here is the
counterpart of `cvpce_tpu/models/gln.py`. Plain tensor code is PyTorch;
the four Pallas kernels are hand-written CUDA C++ (`csrc/nms_hard.cu`,
`csrc/knn_fused.cu`, `csrc/soft_nms.cu`, `csrc/pool_int8_conv.cu`), each
built by `_build.py` with nvcc into a plain-C shared library loaded
through ctypes.

Imports torch, numpy and the standard library only. Entry points run on
`cuda` unless the caller passes `device="cpu"`; there is no automatic
CPU fallback.
"""
