"""Hand-written CUDA kernels of the port and their plain versions.

  ref.py               plain PyTorch versions — what each kernel computes
  decode_attention.py  wrapper of csrc/paged_decode_attention.cu
  prefill_attention.py wrapper of csrc/paged_prefill_attention.cu
  flash_attention.py   wrapper of csrc/flash_attention.cu
  rmsnorm.py           wrapper of csrc/rmsnorm.cu
  adamw.py             wrapper of csrc/adamw.cu (multi-tensor AdamW; its
                       plain version is train/optimizer.py::adamw_leaves_ref,
                       whose pieces the optimizer's UPDATE_PIECE sizes)
  ops.py               dispatch by device: CPU -> plain, CUDA -> kernel
  _build.py            nvcc build (sm_90a) + ctypes loading, on first use
"""
