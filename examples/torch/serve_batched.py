"""Batched serving: prefill a prompt batch, decode greedily through the
pipelined serve step (KV/SSM caches, ring buffers, the lot). Counterpart of
``examples/serve_batched.py`` on ``repro_torch``.

    PYTHONPATH=src python examples/torch/serve_batched.py --arch codeqwen1.5-7b [--device cpu]

The arch's smoke config, one stage, one micro-batch, seed 0, as the JAX
example; ``--device`` defaults to ``cuda``, where the prefill runs the
hand-written flash (and SSD) kernels.
"""

import argparse

from repro_torch.launch.serve import build_parser, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--decode-steps", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    return run(build_parser().parse_args([
        "--arch", a.arch, "--prompt-len", str(a.prompt_len), "--decode-steps",
        str(a.decode_steps), "--batch", str(a.batch), "--stages", "1", "--chunks", "1",
        "--seed", "0", "--device", a.device,
    ]))


if __name__ == "__main__":
    main()
