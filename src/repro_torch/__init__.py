"""PyTorch + CUDA port of the Tangram reproduction (``repro``).

Module paths mirror ``src/repro/``.  The package imports torch, numpy and
the standard library only; its entry points take an explicit ``device``
that defaults to ``"cuda"`` (see :mod:`repro_torch.device`), and its
kernels are hand-written CUDA built on first use
(:mod:`repro_torch.kernels._build`).
"""
