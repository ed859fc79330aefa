"""Configuration dataclasses of the PyTorch/CUDA port.

The port's own copy of the JAX package's ``config.py``: the same classes,
field names and defaults, so one YAML file loads in both packages and a test
can hand one set of options to both (``from_jax``).  The port imports
nothing of the JAX package; SGM has no learned weights, so these options are
all the state that is carried across.

``SGMOptions`` mirrors the reference C struct ``SGMOption``
(``SemiGlobalMatching/SemiGlobalMatching/SemiGlobalMatching.h:24-40``, filled
in ``main.c:48-65``).  It is frozen and hashable, so it can key a cache.
``EngineConfig.use_pallas`` keeps its name and means "use the hand-written
CUDA kernels"; ``compute16`` is the TPU's register-width choice with
bit-identical results and is ignored by the engine (the 16-bit recurrence
lives in ``probes/int16_recurrence.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Matches the reference's INVALID_FLOAT (SemiGlobalMatching.h:12): disparity
# values that fail validation are set to +inf.
INVALID_FLOAT = float("inf")


@dataclasses.dataclass(frozen=True)
class SGMOptions:
    """Field-for-field mirror of the reference ``SGMOption`` struct.

    Defaults reproduce the reference CLI configuration (``main.c:48-65``).
    """

    num_paths: int = 8                # 4 or 8 aggregation directions
    min_disparity: int = 0
    max_disparity: int = 64

    is_check_unique: bool = True
    uniqueness_ratio: float = 0.99

    is_check_lr: bool = True
    lrcheck_thres: float = 1.0

    is_remove_speckles: bool = True
    min_speckle_area: int = 50

    p1: int = 10
    p2_init: int = 150

    # --- framework-only knobs (no reference equivalent) ------------------
    # Median behaviour: the reference calls MedianFilter in place
    # (SGM_Match, SemiGlobalMatching.c:120) so later pixels read already
    # filtered neighbours.  ``median_inplace=True`` reproduces that raster
    # recurrence exactly via a t=2i+j wavefront
    # (ops/postprocess.median_filter_3x3_inplace), ~2H+W sequential steps,
    # so it is the bit-parity mode; the default stays the standard
    # out-of-place median.
    median_inplace: bool = False

    def __post_init__(self) -> None:
        if self.min_disparity < 0:
            # the reference's min_disparity is uint16_t (SemiGlobalMatching.h
            # :28); the LR check bounds its select band by max_disparity
            raise ValueError(
                f"min_disparity ({self.min_disparity}) must be >= 0")
        if self.max_disparity <= self.min_disparity:
            raise ValueError(
                f"max_disparity ({self.max_disparity}) must exceed "
                f"min_disparity ({self.min_disparity})"
            )
        if self.num_paths not in (4, 8):
            raise ValueError("num_paths must be 4 or 8")
        if self.p1 < 0 or self.p2_init < 0:
            raise ValueError("p1/p2_init must be non-negative")

    @property
    def disp_range(self) -> int:
        return self.max_disparity - self.min_disparity

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SGMOptions":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SGMOptions fields: {sorted(unknown)}")
        return cls(**d)


# Reference CLI configuration, for convenience in tests/benchmarks.
REFERENCE_CLI_OPTIONS = SGMOptions()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution configuration of the engine (no reference equivalent: the
    reference hardcodes everything at compile time)."""

    # Use the hand-written CUDA kernels for the hot ops; False runs the
    # plain PyTorch version of every stage.  The name is the JAX package's,
    # so that one YAML file serves both.
    use_pallas: bool = True

    # Spatial tiling across devices (see parallel/tiles.py):
    #  'none'      : whole image per device
    #  'exact'     : H-tiles, K-round chained cross-tile scan carries
    #  'pipelined' : H-tiles, exact, microbatch wavefront through the ring
    #  'local'     : H-tiles with tile-local path restarts (overlap SGM)
    tile_mode: str = "none"

    # Diagonal path geometry (see ops/aggregation.py):
    #  'wrap'    : the reference's mod-W edge-wrapping diagonals (default)
    #  'restart' : standard SGM — paths restart at image edges
    diagonal_mode: str = "wrap"

    # The JAX package's switch for a 16-bit DP-scan recurrence on the TPU
    # (bit-equal results).  Kept so that configs load; the engine ignores it.
    compute16: bool = False

    def __post_init__(self) -> None:
        if self.tile_mode not in ("none", "exact", "pipelined", "local"):
            raise ValueError(f"unknown tile_mode {self.tile_mode!r}")
        if self.diagonal_mode not in ("wrap", "restart"):
            raise ValueError(f"unknown diagonal_mode {self.diagonal_mode!r}")


def load_yaml_config(path) -> Tuple[SGMOptions, EngineConfig]:
    """Load ``{sgm: {...}, engine: {...}}`` YAML into config dataclasses.

    The reference has no config files at all (constants + struct literals);
    the file format is shared with the JAX package."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    opts = SGMOptions.from_dict(raw.get("sgm", {}))
    eng_raw = dict(raw.get("engine", {}))
    known = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = set(eng_raw) - known
    if unknown:
        raise ValueError(f"unknown EngineConfig fields: {sorted(unknown)}")
    return opts, EngineConfig(**eng_raw)


def save_yaml_config(path, options: SGMOptions,
                     engine: EngineConfig = EngineConfig()) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(
            {"sgm": dataclasses.asdict(options),
             "engine": dataclasses.asdict(engine)}, f, sort_keys=False)


def from_jax(obj):
    """The port's ``SGMOptions`` / ``EngineConfig`` with the fields of the
    JAX package's dataclass of the same name (or of the port's own, which
    comes back equal).  Fields are carried by name; a field this package
    does not know raises."""
    target = {"SGMOptions": SGMOptions, "EngineConfig": EngineConfig}.get(
        type(obj).__name__)
    if target is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"expected an SGMOptions or EngineConfig dataclass, "
                        f"got {type(obj).__name__}")
    return target(**dataclasses.asdict(obj))
