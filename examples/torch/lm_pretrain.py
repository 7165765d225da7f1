"""End-to-end LM pretraining through the pipelined train step, smoke-sized.
Counterpart of ``examples/lm_pretrain.py`` on ``repro_torch``.

    PYTHONPATH=src python examples/torch/lm_pretrain.py --arch mamba2-130m --steps 50

To train the ~100M-param model for a few hundred steps:

    PYTHONPATH=src python examples/torch/lm_pretrain.py --arch mamba2-130m \\
        --full-arch --steps 300 --seq 256 --batch 8

``--device`` defaults to ``cuda`` (the flash and SSD kernels in the
forward); ``--device cpu`` runs their plain versions.
"""

import argparse

from repro_torch.launch.train import build_parser, run_lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--full-arch", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    out = run_lm(build_parser().parse_args([
        "--mode", "lm", "--arch", a.arch, *(["--full-arch"] if a.full_arch else []),
        "--steps", str(a.steps), "--seq", str(a.seq), "--batch", str(a.batch),
        "--stages", "1", "--chunks", "2", "--lr", "3e-4", "--seed", "0", "--log-every", "10",
        "--device", a.device,
    ]))
    print("loss moved:", out["first_loss"], "->", out["last_loss"])
    return out


if __name__ == "__main__":
    main()
