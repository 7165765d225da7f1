"""Batched LM serving driver: prefill a request batch, then decode greedily
through the pipelined serve step. Counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \\
        --prompt-len 64 --decode-steps 16 --batch 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \\
        --full-arch --prompt-len 512 --decode-steps 16 --batch 8

The flags are the JAX driver's, plus ``--device`` (default ``cuda``, which
raises without a card; ``cpu`` asks for the CPU). Under ``torchrun`` the
``--stages`` ring runs one stage per rank (``core.cli.join_lm_ring``: the
world must be a multiple dp of ``--stages``; NCCL, or gloo with ``--device
cpu``): dp > 1 replicas of the ring each serve ``1/dp`` of the batch's
rows (the reference's data axis, with its ZeRO-3 gathers and MoE's
``gathered`` mode), each rank draws and holds only its own stage's
weights, shards and caches, every rank returns the same tokens, and rank 0
prints the result, with ``ranks``, ``data_parallel`` and each rank's peak
memory (``peak_mem_gb_per_rank``):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen2.5-32b --full-arch --stages 4 --prompt-len 512 --batch 8
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch codeqwen1.5-7b --stages 2 --batch 8 --device cpu

Weights are random, drawn on the device from ``--seed``; ``--full-arch`` takes the published widths
and depth, else the arch's smoke config. On the card the prefill's
attention runs the hand-written flash kernel and Mamba's scan the SSD
kernel (zamba2's hybrid stage runs both). On a frontend arch
(musicgen-large, qwen2-vl-2b) the prompt's first ``int(prompt_len ·
frontend_frac)`` rows are precomputed frontend embeddings drawn from
``--seed`` (``data.tokens.frontend_embeds``), the rest tokens, as the JAX
launcher draws them. The prefill fills a prompt-width
cache, which is spliced into the wider decode cache (the JAX driver's
host-side splice), and each decode step feeds back its argmax token. The
printed result carries the JAX driver's keys plus ``tokens_per_s`` (tokens
generated over prefill + decode wall time), ``peak_mem_gb`` (the card's
peak allocation; None on the CPU), ``params`` and the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ArchConfig, ShapeConfig, get_arch
from repro_torch.core import ranks
from repro_torch.core.cli import join_lm_ring, resolve_device
from repro_torch.data.tokens import frontend_embeds, token_batch
from repro_torch.models.transformer.model import (
    Topology, abstract_params, check_supported, frontend_rows, held_stages, init_cache,
    init_params, make_prefill_step, make_serve_step,
)


@dataclasses.dataclass
class Generation:
    """What a greedy generation produced: tokens (B, decode_steps + 1) —
    the prefill's argmax first — the prefill's last-token logits, the first
    decode step's logits (the next position's; None without decode steps),
    host wall seconds of the prefill and of all decode steps, each ended by
    a device synchronize, and the decode cache the last step left (its next
    position is the prompt's rows + decode_steps)."""

    tokens: np.ndarray
    prefill_logits: torch.Tensor
    first_decode_logits: torch.Tensor | None
    prefill_s: float
    decode_s: float
    cache: dict | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def splice(dst: dict, src: dict) -> dict:
    """Copy a prefill cache into a wider decode cache, in place: KV-like
    leaves (num_stages, num_micro, slots, b_mb, W, ...) fill their first W
    ring slots; other leaves are copied whole (``repro.launch.serve``'s
    splice); a hybrid's ``{"mamba", "attn"}`` parts each so."""
    for name, d in dst.items():
        s = src[name]
        if isinstance(d, dict):
            splice(d, s)
        elif d.ndim >= 5 and s.ndim == d.ndim and s.shape[:3] == d.shape[:3]:
            d[:, :, :, :, :s.shape[4]].copy_(s)
        else:
            d.copy_(s)
    return dst


def prompt_batch(prompt: torch.Tensor, frontend: torch.Tensor | None) -> dict:
    """The prefill's batch: ``tokens`` and, on a frontend arch, the rows
    ahead of them."""
    return {"tokens": prompt} if frontend is None else {"tokens": prompt,
                                                        "frontend_embeds": frontend}


@torch.inference_mode()
def generate(cfg: ArchConfig, topo: Topology, params: dict, prompt: torch.Tensor,
             decode_steps: int, frontend: torch.Tensor | None = None) -> Generation:
    """Prefill ``prompt`` (B, S_text), after the frontend embeddings
    ``frontend`` (B, s_front, d) where the arch has a frontend, and decode
    ``decode_steps`` greedy tokens on the prompt's device. The caches take
    the params' dtype (``embed``'s), as the reference's step builders give
    their caches the dtype of their params."""
    dev = prompt.device
    dtype = params["embed"].dtype
    b = prompt.shape[0]
    plen = prompt.shape[1] + (0 if frontend is None else frontend.shape[1])
    pshape = ShapeConfig("serve_prefill", plen, b, "prefill")
    dshape = ShapeConfig("serve_decode", plen + decode_steps + 16, b, "decode")
    prefill = make_prefill_step(cfg, topo, pshape)
    step = make_serve_step(cfg, topo, dshape)

    pcache = init_cache(cfg, topo, pshape, dtype=dtype, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, pcache = prefill(params, pcache, prompt_batch(prompt, frontend))
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    dcache = splice(init_cache(cfg, topo, dshape, dtype=dtype, device=dev), pcache)
    del pcache
    tok = logits.argmax(dim=-1).to(torch.int32)
    generated, first = [tok], None
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(decode_steps):
        tok, dcache, step_logits = step(params, dcache, {"tokens": tok, "pos": plen + i})
        first = step_logits if i == 0 else first
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = torch.stack(generated, dim=1).cpu().numpy()
    return Generation(tokens, logits, first, t_prefill, t_decode, dcache)


@dataclasses.dataclass
class Served:
    """One ``serve`` run: the printed summary and what produced it (the
    prompt's tokens and, on a frontend arch, its frontend embeddings; on a
    ring position, its own stage's params and the group ``serve`` joined)."""

    summary: dict
    cfg: ArchConfig
    topo: Topology
    params: dict
    prompt: torch.Tensor
    frontend_embeds: torch.Tensor | None
    generation: Generation
    joined: ranks.Ranks | None = None

    @property
    def prompt_len(self) -> int:
        """Rows of the prompt: frontend rows and tokens."""
        return self.prompt.shape[1] + (0 if self.frontend_embeds is None
                                       else self.frontend_embeds.shape[1])

    def batch(self) -> dict:
        """The prefill's batch of this run."""
        return prompt_batch(self.prompt, self.frontend_embeds)


def serve(args, cfg: ArchConfig | None = None, dtype=torch.float32) -> Served:
    """Build the model on ``--device``, serve one batch, summarize. ``cfg``:
    a built config (a caller may cut its depth), else ``--arch``'s.
    ``dtype``: the params' and so the caches' (float32, the launcher's, by
    default; ``torch.bfloat16`` is the reference's own). Under
    torchrun this rank joins the ``--stages`` ring (``Served.joined``; the
    caller leaves it) and holds its own stage's rows of its data shard."""
    cfg = get_arch(args.arch, smoke=not args.full_arch) if cfg is None else cfg
    check_supported(cfg)
    stages = max(args.stages, 1)
    joined, grid = join_lm_ring(stages, args.device)
    device = joined.device if joined is not None else resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    topo = Topology(num_stages=stages, num_micro=args.chunks,
                    data=1 if grid is None else grid.dp, ring=grid)
    params = init_params(cfg, seed=args.seed, num_stages=stages, device=device, topo=topo,
                         stages=None if grid is None else held_stages(topo, grid.position),
                         data_rank=None if grid is None else grid.replica, dtype=dtype)
    s_front = frontend_rows(cfg, args.prompt_len)
    n_text = args.prompt_len - s_front
    prompt = torch.from_numpy(token_batch(
        batch=args.batch, seq=n_text, vocab=cfg.vocab_size, seed=args.seed,
    )[:, :-1][:, :n_text].astype(np.int64)).to(device)
    frontend = torch.from_numpy(frontend_embeds(
        batch=args.batch, seq=s_front, d_model=cfg.d_model, seed=args.seed,
    )).to(device, dtype) if s_front else None

    gen = generate(cfg, topo, params, prompt, args.decode_steps, frontend)
    n_tokens = int(gen.tokens.size)
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    per_rank = ranks.gathered({"peak": peak})
    summary = {
        "arch": cfg.name,
        "batch": args.batch,
        "prefill_s": gen.prefill_s,
        "decode_s_per_tok": gen.decode_s / max(args.decode_steps, 1),
        "tokens_generated": n_tokens,
        "sample": gen.tokens[0][:8].tolist(),
        "tokens_per_s": n_tokens / (gen.prefill_s + gen.decode_s),
        "peak_mem_gb": peak,
        "params": sum(int(p.numel()) for p in _leaves(abstract_params(cfg, stages))),
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    if grid is not None:
        summary["ranks"] = len(per_rank)
        summary["data_parallel"] = grid.dp
        summary["peak_mem_gb_per_rank"] = [r["peak"] for r in per_rank]
    return Served(summary, cfg, topo, params, prompt, frontend, gen, joined)


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def run(args) -> dict:
    """Serve one batch and print the summary dict (the JAX driver's
    ``run``); under torchrun rank 0 alone prints, and every rank leaves
    the group it joined."""
    served = serve(args)
    if ranks.is_leader():
        print(served.summary)
    ranks.leave(served.joined)
    return served.summary


def build_parser() -> argparse.ArgumentParser:
    """The JAX serving driver's flags plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--full-arch", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--stages", type=int, default=1)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to run on: cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
