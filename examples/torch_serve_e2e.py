"""End-to-end serving driver on the PyTorch + CUDA port: batched requests
through a real detector.

The counterpart of ``examples/serve_e2e.py``: the edge pipeline (K5 on
the card) emits patches, the unified serving engine (``core.engine``)
batches them through the SLO-aware invoker pool, the hand-written stitch
kernel K1 assembles canvases, the detector serves each batch on the
``DeviceExecutor`` and K2 cuts the evidence back out.  On the CPU every
kernel takes its plain PyTorch version.  Extra arguments go to the
driver (``python -m repro_torch.launch.serve --help``).

    PYTHONPATH=src python examples/torch_serve_e2e.py                # card
    PYTHONPATH=src python examples/torch_serve_e2e.py --device cpu
"""
import sys

from repro_torch.launch import serve

ARGS = ["--frames", "40", "--canvas", "192", "--slo", "2.0",
        "--use-pallas-stitch"]


def main(argv=None):
    serve.main(ARGS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
