"""Train the Tangram canvas detector end-to-end on stitched canvases, on
the PyTorch + CUDA port.

The counterpart of ``examples/train_detector.py``: the data loader runs
the real pipeline (scene -> Alg. 1 -> stitching -> canvas compositing)
and trains the ViT-backbone detector for a few hundred steps with
checkpointing; a failure drill at step 60 exercises the
restore-and-resume path.  Reduced config, as the JAX example's.  Training
launches no hand-written kernel (the reference trains without a Pallas
kernel).

    PYTHONPATH=src python examples/torch_train_detector.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_detector.py --device cpu
"""
import argparse
import tempfile

from repro_torch.config import DetectorConfig, ShapeConfig
from repro_torch.launch.train import train
from repro_torch.training.elastic import FailureEvent, FailureInjector


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--canvas", type=int, default=128)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    model = DetectorConfig(
        name="detector-cpu", canvas=args.canvas, patch=32, n_layers=2,
        d_model=96, n_heads=4, d_ff=192, param_dtype="float32",
        compute_dtype="float32")
    shape = ShapeConfig("train", "train", img_res=args.canvas,
                        global_batch=args.batch)
    events = [FailureEvent(min(60, args.steps // 2), "host", 0)]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        injector = FailureInjector(events)
        _, losses = train(model, shape, steps=args.steps, ckpt_dir=ckpt_dir,
                          ckpt_every=20, injector=injector, log_every=10,
                          device=args.device)
    k = max(len(losses) // 10, 1)
    print(f"\nloss: first-{k} mean {sum(losses[:k])/k:.4f} -> "
          f"last-{k} mean {sum(losses[-k:])/k:.4f}")
    assert sum(losses[-k:]) < sum(losses[:k]), "training did not learn"
    print("detector training learns + survives the failure drill")
    # a drill that fired and returned restored its checkpoint
    return losses, len(events) - len(injector.events)


if __name__ == "__main__":
    main()
