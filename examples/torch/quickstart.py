"""Quickstart: train the paper's GAT on (synthetic) Cora, one device.
Counterpart of ``examples/quickstart.py`` on ``repro_torch``.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

``--device`` defaults to ``cuda`` (the hand-written GAT kernels run on the
card only under ``--backend kernel`` pipelines; this full-batch run uses the
padded layout). ``--dataset`` and ``--epochs`` (cora, 100, as the JAX
example) size the run.
"""

import argparse

from repro_torch.core.cli import resolve_device
from repro_torch.graphs import load_dataset
from repro_torch.models.gnn.net import build_paper_gat
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    g = load_dataset(args.dataset).to(resolve_device(args.device))
    edges = (int(g.mask.sum()) - g.num_nodes) // 2  # directed slots less self-loops, halved
    print(f"{args.dataset}: {g.num_nodes} nodes, {edges} edges, {g.num_features} features, "
          f"{g.num_classes} classes, on {g.device}")
    model = build_paper_gat(g.num_features, g.num_classes)
    res = train(model, g, epochs=args.epochs, log_every=20)
    print(f"test accuracy: {res.test_acc:.3f}  "
          f"(avg epoch {res.avg_epoch_s * 1e3:.1f} ms, first {res.first_epoch_s:.2f} s)")
    return res


if __name__ == "__main__":
    main()
