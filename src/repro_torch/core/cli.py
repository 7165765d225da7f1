"""One definition of the pipeline CLI surface.

Counterpart of ``repro.core.cli``: ``add_pipeline_args`` declares the flag
set on a parser and ``PipelineCLIConfig`` is the parsed bundle with its
``gpipe_config()`` translation. The flag names and spellings are the JAX
package's, so its command lines carry over; ``--device`` (default
``cuda``) is new. ``--overlap async`` runs the ``double-buffer`` program:
the reference's async adds XLA scheduler flags, which PyTorch has no
counterpart of.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import ranks
from repro_torch.core.pipeline import GPipeConfig
from repro_torch.core.schedule import Placement

ENGINE_CHOICES = ("host", "compiled")
SCHEDULE_CHOICES = ("fill_drain", "gpipe", "1f1b", "interleaved", "zb-h1", "zb-v")
PARTITION_CHOICES = ("uniform", "profiled")
BACKEND_CHOICES = ("padded", "kernel", "pallas", "dense")
OVERLAP_CHOICES = ("off", "double-buffer", "async")

# layer-count split of the 6-layer sequential paper model
UNIFORM_BALANCES = {2: (3, 3), 3: (2, 2, 2), 4: (2, 1, 1, 2), 6: (1,) * 6}


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on. ``cuda`` with no card raises —
    entry points never fall back to the CPU; pass ``cpu`` to ask for it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available; pass --device cpu "
            "to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def join_ranks(cli: "PipelineCLIConfig") -> "ranks.Ranks | None":
    """Join torchrun's process group when ``WORLD_SIZE`` > 1 (None
    otherwise): the compiled engine then runs one ring position per rank,
    on a world of the ring's D or ``--data-parallel`` x D ranks
    (``ranks.RankGrid`` refuses any other; under ``--auto`` the planner
    fits the ring to the world). The host engine's several-card form is
    ``GPipeConfig.devices`` in one process, so ``--engine host`` raises
    here. ``--auto`` and ``--partition profiled`` plan on rank 0 alone and
    hand every rank the same plan (``core.autotune.plan_for_cli``,
    ``launch.train.profiled_balance``)."""
    if ranks.planned_world_size() <= 1:
        return None
    if cli.engine == "host":
        raise ValueError(
            "--engine host under torchrun: the host engine runs in one process "
            "(GPipeConfig.devices places its stages on several cards); pass --engine compiled"
        )
    return ranks.join(cli.device)


def join_lm_ring(positions: int, device: str):
    """``(ranks.Ranks, ranks.RankGrid)`` of an LM launcher under torchrun,
    ``(None, None)`` in one process. A world of ``dp · positions`` ranks
    (``positions``: ``--stages``, or ``--pipe-devices`` interleaved) joins
    ``RankGrid(dp, positions)``: ``dp`` replicas of the stage ring over the
    data axis (the reference's ``fsdp`` axis: ZeRO-3 gathers, MoE's expert
    parallelism), one ring position of one replica per rank. Any other
    world raises ``ValueError`` before joining: a rank outside the grid
    would hang the others."""
    world = ranks.planned_world_size()
    if world <= 1:
        return None, None
    if positions < 1 or world % positions:
        raise ValueError(
            f"a world of {world} ranks cannot hold a stage ring of {positions} positions: "
            f"run a multiple of {positions} ranks (data replicas x {positions} positions), "
            f"or pass a --stages that divides {world} (--pipe-devices under --schedule "
            "interleaved)")
    joined = ranks.join(device)
    return joined, ranks.RankGrid(world // positions, positions)


def log_overlap(cli: "PipelineCLIConfig") -> None:
    """Say once that ``--overlap async`` runs the ``double-buffer`` program."""
    if cli.overlap == "async":
        print("[overlap] async runs the double-buffer program: the wire copies already run "
              "on a stream of their own, and the reference's XLA latency-hiding flags have "
              "no PyTorch counterpart")


def add_pipeline_args(
    ap,
    *,
    engine: str = "host",
    schedule: str = "fill_drain",
    chunks: int = 1,
    stages: int = 1,
    backend: str = "padded",
):
    """Declare the pipeline flag set on ``ap`` (a parser or group)."""
    ap.add_argument("--engine", default=engine, choices=list(ENGINE_CHOICES),
                    help="pipeline engine: the host-driven GPipe loop, or the compiled "
                         "single program (one CUDA-graph replay per step on a card)")
    ap.add_argument("--schedule", default=schedule, choices=list(SCHEDULE_CHOICES),
                    help="pipeline schedule (read by training; serving's eval ignores it)")
    ap.add_argument("--stages", type=int, default=stages)
    ap.add_argument("--chunks", type=int, default=chunks)
    ap.add_argument("--pipe-devices", type=int, default=None,
                    help="interleaved/zb-v: devices the timeline places stages on "
                         "(virtual stages = stages/devices; default 2)")
    ap.add_argument("--partition", default="uniform", choices=list(PARTITION_CHOICES),
                    help="stage balance: layer-count split or the cost-model partitioner "
                         "(profiles per-layer fwd/B/W on a padded chunk on the device, "
                         "minimizes the schedule's weighted makespan)")
    ap.add_argument("--placement", default=None,
                    help="stage->device ring placement as comma ints, e.g. '1,2,3,0'")
    ap.add_argument("--backend", default=backend, choices=list(BACKEND_CHOICES),
                    help="aggregation: plain padded gathers, a dense masked adjacency, "
                         "or the hand-written CUDA kernels over the degree-bucketed "
                         "layout ('pallas' is an alias of 'kernel')")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="graph-partition replicas (compiled engine): chunks split "
                         "data_parallel ways, gradients reduced in the canonical chunk "
                         "order, so the update is bit-identical to 1 replica; one card "
                         "runs the single-replica program over all chunks")
    ap.add_argument("--overlap", default="off", choices=list(OVERLAP_CHOICES),
                    help="communication/compute overlap (compiled engine): double-buffer "
                         "retimes the tick arrays so each wire copy is posted on a stream "
                         "of its own one tick before its arrivals are consumed "
                         "(bit-identical updates); async runs the same program (the "
                         "reference's XLA scheduler flags have no PyTorch counterpart; "
                         "core.overlap_report measures the overlap)")
    ap.add_argument("--auto", action="store_true",
                    help="self-tuning planner (core.autotune.plan_pipeline): profile "
                         "per-layer costs once, enumerate schedule x chunks x balance x "
                         "placement, pick the argmin predicted step time; overrides "
                         "--schedule/--chunks/--partition/--placement")
    ap.add_argument("--auto-budget", type=int, default=None,
                    help="cap on the candidate configurations --auto evaluates "
                         "(ranked enumeration order; default: exhaustive)")
    ap.add_argument("--dry-run", action="store_true",
                    help="with --auto: print the ranked candidate table and exit "
                         "without training or serving")
    ap.add_argument("--device", default="cuda",
                    help="device to run on: cuda (default; raises without a card) or cpu")
    return ap


@dataclasses.dataclass
class PipelineCLIConfig:
    """The parsed pipeline flag bundle."""

    engine: str = "host"
    schedule: str = "fill_drain"
    chunks: int = 1
    stages: int = 1
    partition: str = "uniform"
    placement: str | None = None
    pipe_devices: int | None = None
    backend: str = "padded"
    data_parallel: int = 1
    overlap: str = "off"
    auto: bool = False
    auto_budget: int | None = None
    dry_run: bool = False
    device: str = "cuda"

    @classmethod
    def from_args(cls, args) -> "PipelineCLIConfig":
        """Lift the flag set off an argparse namespace (missing attributes
        fall back to the defaults)."""
        d = {f.name: getattr(args, f.name, f.default) for f in dataclasses.fields(cls)}
        return cls(**d)

    @property
    def resolved_pipe_devices(self) -> int | None:
        """--pipe-devices with the round-robin default applied: interleaved
        and zb-v place V = stages/2 virtual stages on 2 devices unless told
        otherwise."""
        if self.schedule in ("interleaved", "zb-v") and self.pipe_devices is None:
            return 2
        return self.pipe_devices

    def parsed_placement(self) -> Placement | None:
        """The --placement comma string as a ``Placement``."""
        if not self.placement:
            return None
        return Placement(tuple(int(x) for x in self.placement.split(",")))

    def uniform_balance(self) -> tuple[int, ...]:
        """The layer-count split of the 6-layer paper model for --stages."""
        try:
            return UNIFORM_BALANCES[self.stages]
        except KeyError:
            raise ValueError(
                f"--stages {self.stages} has no uniform split of the 6-layer "
                f"paper model; supported: {sorted(UNIFORM_BALANCES)}"
            ) from None

    def gpipe_config(self, balance=None, device=None) -> GPipeConfig:
        """The assembled engine config (``balance`` defaults to uniform,
        ``device`` to ``--device``; a rank passes its own card)."""
        return GPipeConfig(
            balance=tuple(balance if balance is not None else self.uniform_balance()),
            chunks=self.chunks,
            schedule=self.schedule,
            num_devices=self.resolved_pipe_devices,
            placement=self.parsed_placement(),
            engine=self.engine,
            backend=self.backend,
            data_parallel=self.data_parallel,
            overlap=self.overlap,
            device=str(device if device is not None else resolve_device(self.device)),
        )
