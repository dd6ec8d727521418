"""WorkloadSpec — the benchmark-facing declarative API.

Port of ``src/repro/bench/spec.py``. A workload is one paper
table/figure: a name, its paper analog, a parameter ``Space``, the
device placement it needs (a :class:`Placement`), selection tags, and a
``build(point, ctx) -> {step_name: thunk}`` factory. Registration via
the ``@workload`` decorator puts it in the registry that the CLI
(``python -m repro_torch.bench``) and ``WorkloadRunner`` drive.

``build`` is called once per expanded point with a ``RunContext`` and
returns an ordered mapping of named zero-arg step thunks, each producing
a metrics dict. Cross-point state (inputs, weights) lives in
``ctx.memo``; timing is ``ctx.measure`` — owned by the runner, not the
workload.

``Placement`` names a device mesh by parallelism axis (``{"dp": 4}``,
``{"dp": 2, "tp": 2}``), as in the reference, and maps it onto the
mesh axes the sharding rules name (``mesh_shape`` / ``mesh_axes``:
``data`` and ``model`` always, ``stage`` for ``pp``). A point whose
placement spans more than one device runs in that many ranks
(``launch.mesh``) where the process can start them, and is recorded as
``deferred`` with its sbatch script where it cannot.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Union

from repro_torch.core.params import Space

# step thunk: () -> metrics dict;  build: (point, ctx) -> {name: thunk}
StepFns = Dict[str, Callable[[], dict]]
BuildFn = Callable[[dict, "object"], StepFns]

#: tags with agreed meaning; workloads may add their own on top.
KNOWN_TAGS = ("smoke", "full", "train", "serve", "vision", "kernels",
              "analysis")

#: placement axis -> mesh axis name (the names the sharding rules in
#: repro_torch.parallel.sharding key on; unknown axes pass through)
MESH_AXIS_NAMES = {"dp": "data", "tp": "model", "pp": "stage", "pod": "pod"}
#: canonical placement axis order — fixes the mesh's device-major order
#: (lowest-bandwidth/lowest-frequency collective axes first) and makes
#: every spelling of the same mesh produce one canonical label
_AXIS_ORDER = ("pod", "dp", "tp", "pp")

_PLACEMENT_RE = re.compile(r"([a-zA-Z]+)\s*=?\s*(\d+)")


@dataclass(frozen=True)
class Placement:
    """A device mesh shape, named by parallelism axis.

    ``axes`` is a canonically-ordered tuple of ``(axis, size)`` pairs —
    construct through :meth:`of`, which normalizes every accepted
    spelling (int, ``"dp2tp2"``-style label, dict, Placement) to the
    same value, so placements compare/hash by meaning, not by spelling.
    """

    axes: tuple  # ((axis, size), ...) in canonical axis order

    @classmethod
    def of(cls, value: Union[int, str, dict, "Placement", None],
           ) -> "Placement":
        """Normalize any accepted placement spelling.

        int ``n`` -> pure data parallel ``{"dp": n}`` (the scalar
        ``n_devices`` upconversion); str -> parsed label (``"dp4"``,
        ``"dp2tp2"``, ``"dp=2,tp=2"``); dict -> axis sizes.
        """
        if isinstance(value, Placement):
            return value
        if value is None:
            value = 1
        if isinstance(value, int):
            if value < 1:
                raise ValueError(f"placement needs >= 1 device, got {value}")
            value = {"dp": value}
        if isinstance(value, str):
            pairs = _PLACEMENT_RE.findall(value)
            if not pairs or "".join(a + n for a, n in pairs) != re.sub(
                    r"[\s,=]", "", value):
                raise ValueError(
                    f"cannot parse placement {value!r}; expected e.g. "
                    f"'dp4', 'dp2tp2', or 'dp=2,tp=2'")
            value = {}
            for a, n in pairs:
                if a in value:
                    raise ValueError(f"placement {pairs} repeats axis {a!r}")
                value[a] = int(n)
        if not isinstance(value, dict) or not value:
            raise TypeError(f"cannot interpret placement from "
                            f"{type(value).__name__}: {value!r}")
        for a, n in value.items():
            if not isinstance(n, int) or n < 1:
                raise ValueError(f"placement axis {a!r} must be a positive "
                                 f"int, got {n!r}")
        order = {a: i for i, a in enumerate(_AXIS_ORDER)}
        names = sorted(value, key=lambda a: (order.get(a, len(order)), a))
        return cls(axes=tuple((a, int(value[a])) for a in names))

    @property
    def n_devices(self) -> int:
        n = 1
        for _, size in self.axes:
            n *= size
        return n

    @property
    def label(self) -> str:
        """Canonical compact spelling, e.g. ``"dp2tp2"`` — the value a
        ``placement`` Space axis carries and the point-key component."""
        return "".join(f"{a}{n}" for a, n in self.axes)

    def dict(self) -> dict:
        return dict(self.axes)

    def _mesh_entries(self) -> tuple:
        """(mesh axis name, size) pairs. The "data" and "model" axes are
        always present (size 1 when the placement doesn't use them): the
        sharding rules name them unconditionally."""
        sizes = self.dict()
        entries = []
        if "pod" in sizes:
            entries.append(("pod", sizes.pop("pod")))
        entries.append(("data", sizes.pop("dp", 1)))
        entries.append(("model", sizes.pop("tp", 1)))
        if "pp" in sizes:
            entries.append(("stage", sizes.pop("pp")))
        for a in sorted(sizes):     # unknown axes pass through by name
            entries.append((MESH_AXIS_NAMES.get(a, a), sizes[a]))
        return tuple(entries)

    @property
    def mesh_shape(self) -> tuple:
        return tuple(n for _, n in self._mesh_entries())

    @property
    def mesh_axes(self) -> tuple:
        """Mesh axis names (duck-typed by ``launch.mesh.mesh_for``)."""
        return tuple(a for a, _ in self._mesh_entries())

    def __str__(self) -> str:
        return self.label


class UnknownWorkloadError(KeyError):
    """Raised when a suite name is not in the registry."""

    def __init__(self, name: str, known: Iterable[str]):
        super().__init__(name)
        self.name = name
        self.known = sorted(known)

    def __str__(self) -> str:
        return (f"unknown workload {self.name!r}; registered: "
                f"{', '.join(self.known) or '(none)'}")


@dataclass(frozen=True)
class WorkloadSpec:
    """Declarative description of one benchmark workload."""

    name: str
    analog: str                       # the paper table/figure it reproduces
    space: Space                      # full-run parameter space
    build: BuildFn
    #: default device mesh; a ``placement`` Space axis overrides per point
    placement: Placement = Placement.of(1)
    tags: frozenset = frozenset()
    smoke_axes: Optional[dict] = None  # axis overrides for smoke runs
    result_columns: Optional[list] = None
    primary_metric: Optional[str] = None  # headline column for emit lines
    heatmap_keys: Optional[tuple] = None  # (row, col, val) -> render heatmap
    #: per-metric relative tolerances for the records' compare gate
    #: (``python -m repro_torch.bench compare``)
    compare_tols: Optional[dict] = None
    description: str = ""

    def placement_for(self, pt: dict) -> Placement:
        """The resolved mesh for one expanded point: the ``placement``
        axis when the Space carries one, else the spec default."""
        return Placement.of(pt.get("placement", self.placement))

    def max_devices(self, smoke: bool = False,
                    overrides: Optional[dict] = None) -> int:
        """Largest device count any point of the selected space needs."""
        points = self.space_for(smoke, overrides).expand()
        if not points:
            return self.placement.n_devices
        return max(self.placement_for(pt).n_devices for pt in points)

    def space_for(self, smoke: bool = False,
                  overrides: Optional[dict] = None) -> Space:
        """The parameter space to run: full axes, narrowed by the smoke
        preset and/or explicit ``--points`` overrides (constraints kept)."""
        axes = dict(self.space.axes)
        if smoke and self.smoke_axes:
            axes.update(self.smoke_axes)
        for k, v in (overrides or {}).items():
            if k not in axes:
                raise KeyError(f"workload {self.name!r} has no axis {k!r}; "
                               f"axes: {sorted(axes)}")
            axes[k] = list(v) if isinstance(v, (list, tuple)) else [v]
        return Space(axes, list(self.space.constraints))

    def matches(self, tags: Optional[Iterable[str]]) -> bool:
        """OR-selection: any requested tag present selects the workload."""
        if not tags:
            return True
        return bool(self.tags & set(tags))


_REGISTRY: dict[str, WorkloadSpec] = {}


def register(spec: WorkloadSpec) -> WorkloadSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"workload {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def workload(name: str, *, analog: str, space: Space,
             placement: Union[int, str, dict, Placement, None] = None,
             tags: Iterable[str] = (), smoke: Optional[dict] = None,
             result_columns: Optional[list] = None,
             primary_metric: Optional[str] = None,
             heatmap_keys: Optional[tuple] = None,
             compare_tols: Optional[dict] = None):
    """Decorator: register ``build(point, ctx)`` as a WorkloadSpec.

    ``placement`` names the default device mesh (``{"dp": 2, "tp": 2}``,
    ``"pp4"``, ...; default one device).
    """

    def deco(build: BuildFn) -> WorkloadSpec:
        return register(WorkloadSpec(
            name=name, analog=analog, space=space, build=build,
            placement=Placement.of(placement),
            tags=frozenset(tags), smoke_axes=smoke,
            result_columns=result_columns, primary_metric=primary_metric,
            heatmap_keys=heatmap_keys, compare_tols=compare_tols, description=(build.__doc__ or "").strip().splitlines()[0]
            if build.__doc__ else ""))

    return deco


def get_workload(name: str) -> WorkloadSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownWorkloadError(name, _REGISTRY) from None


def workload_names() -> list[str]:
    return sorted(_REGISTRY)


def iter_workloads(names: Optional[Iterable[str]] = None,
                   tags: Optional[Iterable[str]] = None,
                   ) -> list[WorkloadSpec]:
    """Select workloads by explicit names and/or tags (names validate)."""
    if names:
        specs = [get_workload(n) for n in names]
    else:
        specs = [_REGISTRY[n] for n in sorted(_REGISTRY)]
    return [s for s in specs if s.matches(tags)]


def unregister(name: str) -> None:
    """Testing hook: remove a workload (no-op if absent)."""
    _REGISTRY.pop(name, None)
