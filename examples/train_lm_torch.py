"""Train a reduced LM end to end with checkpoint/restart on the port (thin
wrapper over ``python -m repro_torch.launch.train``; kill it mid-run and
re-invoke to see auto-resume). Runs on the CUDA device unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py --arch h2o-danube-1.8b --device cpu
"""
import argparse

from repro_torch.launch import train as train_launcher


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_ckpt")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    argv = ["--arch", args.arch, "--reduced", "--steps", str(args.steps),
            "--batch", "8", "--seq", "128", "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", "25", "--log-every", "10"]
    if args.device is not None:
        argv += ["--device", args.device]
    train_launcher.main(argv)


if __name__ == "__main__":
    main()
