"""fluidframework_tpu_torch — the PyTorch / CUDA port of fluidframework_tpu.

The SharedString serving path (BASELINE config #4) runs here on an NVIDIA
H100: Deli sequencing, the in-memory partitioned log, the columnar ingest
stages, and the batched (doc × segment) merge-tree state held in CUDA
tensors, merged by a hand-written Hopper kernel (``ops/string_kernel.py``,
source ``csrc/string_apply.cu``).

The package imports ``torch`` and numpy only; it keeps its own copy of
every module it needs. Entry points default to ``device="cuda"`` and
raise without a card; ``device="cpu"`` runs the plain PyTorch versions.
"""
