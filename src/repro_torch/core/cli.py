"""One definition of the pipeline CLI surface.

Counterpart of ``repro.core.cli``: ``add_pipeline_args`` declares the flag
set on a parser and ``PipelineCLIConfig`` is the parsed bundle with its
``gpipe_config()`` translation. The flag names and spellings are the JAX
package's, so its command lines carry over; ``--device`` (default
``cuda``) is new. Flags whose machinery is not ported yet (``--auto``,
``--partition profiled``, ``--data-parallel``, ``--overlap``) are declared
and raise by name, with their ROADMAP queue 1 item, when set.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pipeline import GPipeConfig
from repro_torch.core.schedule import Placement

ENGINE_CHOICES = ("host", "compiled")
SCHEDULE_CHOICES = ("fill_drain", "gpipe", "1f1b", "interleaved", "zb-h1", "zb-v")
PARTITION_CHOICES = ("uniform", "profiled")
BACKEND_CHOICES = ("padded", "kernel", "pallas")
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
                    help="pipeline engine: the host-driven GPipe loop ('compiled' "
                         "comes with a later slice)")
    ap.add_argument("--schedule", default=schedule, choices=list(SCHEDULE_CHOICES),
                    help="pipeline schedule (read by training; serving's eval ignores it)")
    ap.add_argument("--stages", type=int, default=stages)
    ap.add_argument("--chunks", type=int, default=chunks)
    ap.add_argument("--pipe-devices", type=int, default=None,
                    help="interleaved/zb-v: devices the timeline places stages on "
                         "(virtual stages = stages/devices; default 2)")
    ap.add_argument("--partition", default="uniform", choices=list(PARTITION_CHOICES),
                    help="stage balance: layer-count split ('profiled' not ported yet)")
    ap.add_argument("--placement", default=None,
                    help="stage->device ring placement as comma ints, e.g. '1,2,3,0'")
    ap.add_argument("--backend", default=backend, choices=list(BACKEND_CHOICES),
                    help="aggregation: plain padded gathers, or the hand-written CUDA "
                         "kernels over the degree-bucketed layout ('pallas' is an "
                         "alias of 'kernel')")
    ap.add_argument("--data-parallel", type=int, default=1, help="not ported yet")
    ap.add_argument("--overlap", default="off", choices=list(OVERLAP_CHOICES),
                    help="not ported yet")
    ap.add_argument("--auto", action="store_true", help="not ported yet")
    ap.add_argument("--auto-budget", type=int, default=None, help="not ported yet")
    ap.add_argument("--dry-run", action="store_true", help="not ported yet (with --auto)")
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

    def __post_init__(self):
        not_ported = {  # flag -> (set?, ROADMAP queue 1 item)
            "--auto": (self.auto, 10),
            "--auto-budget": (self.auto_budget is not None, 10),
            "--dry-run": (self.dry_run, 10),
            "--partition profiled": (self.partition != "uniform", 10),
            "--data-parallel": (self.data_parallel != 1, 12),
            "--overlap": (self.overlap != "off", 13),
        }
        named = [f"{flag} (item {item})" for flag, (is_set, item) in not_ported.items() if is_set]
        if named:
            raise NotImplementedError(
                f"{', '.join(named)}: not ported to repro_torch yet (see ROADMAP queue 1)"
            )

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

    def gpipe_config(self, balance=None) -> GPipeConfig:
        """The assembled engine config (``balance`` defaults to uniform)."""
        return GPipeConfig(
            balance=tuple(balance if balance is not None else self.uniform_balance()),
            chunks=self.chunks,
            schedule=self.schedule,
            num_devices=self.resolved_pipe_devices,
            placement=self.parsed_placement(),
            engine=self.engine,
            backend=self.backend,
            device=str(resolve_device(self.device)),
        )
