"""Simulation configuration: the reference's 15-line ``.in`` parameter file.

PyTorch counterpart of ``navierstokes_parallel_tpu/config.py``.  The JAX
module imports ``jax.numpy`` (for ``jnp_dtype``), so this package keeps its
own copy of the parser; every field of the JAX ``Params`` is kept, so both
packages read every ``configs/*.in`` to the same values, and
``Params.from_mapping(dataclasses.asdict(jax_params))`` carries a JAX
configuration across.

File format (one value per line, ``#`` comments ignored):

    1  problem   (int)    1 = lid-driven cavity, 2 = oscillating lid, ...
    2  f         (float)  lid oscillation frequency (problem 2 only)
    3  i_max     (int)    interior cells in x
    4  j_max     (int)    interior cells in y
    5  a         (float)  domain length in x
    6  b         (float)  domain length in y
    7  T         (float)  integration end time
    8  Re        (float)  Reynolds number
    9  g_x       (float)  body force x
    10 g_y       (float)  body force y
    11 tau       (float)  CFL safety factor
    12 omega     (float)  SOR relaxation factor
    13 epsilon   (float)  SOR relative tolerance
    14 max_it    (int)    SOR max iterations
    15 n_print   (int)    output every n-th step

Optional lines 16-17 (problem 5: Ra, Pr) and 16-19 (problem 6: the initial
liquid box) are parsed as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

# (name, type) in exact file order — the contract from the reference parser.
_FIELD_ORDER = (
    ("problem", int),
    ("f", float),
    ("i_max", int),
    ("j_max", int),
    ("a", float),
    ("b", float),
    ("T", float),
    ("Re", float),
    ("g_x", float),
    ("g_y", float),
    ("tau", float),
    ("omega", float),
    ("epsilon", float),
    ("max_it", int),
    ("n_print", int),
)

_FIELD_COMMENTS = {
    "problem": "problem (1: lid-driven cavity, 2: periodic boundary)",
    "f": "f: frequency of the periodic boundary conditions (only if problem = 2)",
    "i_max": "i_max",
    "j_max": "j_max",
    "a": "Side a length",
    "b": "Side b length",
    "T": "Time to integrate",
    "Re": "Reynolds number",
    "g_x": "x-component of g",
    "g_y": "y-component of g",
    "tau": "Security factor tau.",
    "omega": "Relaxation factor for SOR. (1.0 is Gauss-Seidel)",
    "epsilon": "Relative tolerance for SOR.",
    "max_it": "Maximum iterations for SOR.",
    "n_print": "Print results to file every nth step.",
}

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class Params:
    """All solver parameters, field for field those of the JAX ``Params``.

    Fields past ``n_print`` are not part of the ``.in`` format.  The port
    reads ``dtype``, ``gamma_fixed`` and ``sor_refine_every``; the others
    belong to solvers and models not yet ported (ROADMAP A5-A10) and are
    kept, validated as in JAX, so that a JAX configuration carries across
    unchanged.
    """

    problem: int = 1
    f: float = 1.0
    i_max: int = 128
    j_max: int = 128
    a: float = 1.0
    b: float = 1.0
    T: float = 1.0
    Re: float = 1000.0
    g_x: float = 0.0
    g_y: float = 0.0
    tau: float = 1.0
    omega: float = 1.7
    epsilon: float = 1e-4
    max_it: int = 500
    n_print: int = 1

    # State dtype ("float32" or "float64").
    dtype: str = "float32"
    # Donor-cell upwind weight override; None keeps the reference's
    # adaptive gamma (see the JAX config.py for the rationale).
    gamma_fixed: float | None = None
    # Mixed-precision SOR: re-baseline the f64 master pressure (and check
    # convergence) every K f32 sweeps; 0 disables refinement (ops/sor.py).
    sor_refine_every: int = 64
    disable_pallas: bool = False
    sor_inner_dtype: str = "float32"
    sor_comm_every: int = 8
    particles_per_cell: int = 3
    fft_solves_per_outer: int = 1
    mg_cycles_per_outer: int = 1
    fft_precision: str = "highest"
    outer_precision: str = "float64"
    obstacles: tuple = ()
    obstacle_surfaces: tuple = ()
    obstacle_pressure: str = "auto"
    Ra: float = 0.0
    Pr: float = 0.71
    t_hot: float = 0.5
    t_cold: float = -0.5
    fluid_x0: float = 0.0
    fluid_x1: float = -1.0
    fluid_y0: float = 0.0
    fluid_y1: float = -1.0

    def __post_init__(self):
        if self.problem not in (1, 2, 3, 4, 5, 6):
            raise ValueError(
                f"unknown problem type {self.problem} (expected 1: cavity, "
                f"2: oscillating lid, 3: plane channel, 4: free-slip box, "
                f"5: natural convection, 6: free surface)")
        if self.problem == 6:
            # Only the exact -1 sentinel means "use the default".
            if self.fluid_x1 == -1.0:
                object.__setattr__(self, "fluid_x1", 0.25 * self.a)
            if self.fluid_y1 == -1.0:
                object.__setattr__(self, "fluid_y1", 0.5 * self.b)
            if not (0.0 <= self.fluid_x0 < self.fluid_x1 <= self.a
                    and 0.0 <= self.fluid_y0 < self.fluid_y1 <= self.b):
                raise ValueError(
                    f"problem 6 fluid region [{self.fluid_x0}, "
                    f"{self.fluid_x1}] x [{self.fluid_y0}, {self.fluid_y1}]"
                    f" must be a nonempty box inside the {self.a} x "
                    f"{self.b} domain")
        if self.problem == 5:
            if self.Pr <= 0.0:
                raise ValueError(f"Pr must be > 0, got {self.Pr}")
            if self.Ra < 0.0:
                raise ValueError(f"Ra must be >= 0, got {self.Ra}")
            if self.Ra > 0.0:
                object.__setattr__(
                    self, "Re", float((self.Ra / self.Pr) ** 0.5))
            else:
                object.__setattr__(
                    self, "Ra", float(self.Re * self.Re * self.Pr))
        if self.i_max < 2 or self.j_max < 2:
            raise ValueError("grid must be at least 2x2 interior cells")
        if not (0.0 < self.omega < 2.0):
            raise ValueError(f"SOR omega must be in (0, 2), got {self.omega}")
        if self.max_it < 1:
            raise ValueError("max_it must be >= 1")
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(
                f"dtype must be 'float32' or 'float64', got {self.dtype!r}")
        if self.sor_comm_every < 1:
            raise ValueError(
                f"sor_comm_every must be >= 1, got {self.sor_comm_every}")
        if not (1 <= self.fft_solves_per_outer <= 8):
            raise ValueError(
                f"fft_solves_per_outer must be in 1..8, got "
                f"{self.fft_solves_per_outer}")
        if not (2 <= self.particles_per_cell <= 16):
            raise ValueError(
                f"particles_per_cell must be in 2..16, got "
                f"{self.particles_per_cell}")
        if self.obstacles:
            # Normalize to a hashable tuple-of-tuples (callers may pass
            # lists, and asdict() of a JAX Params gives tuples of tuples).
            rects = tuple(tuple(int(x) for x in r) for r in self.obstacles)
            object.__setattr__(self, "obstacles", rects)
            for r in rects:
                if len(r) != 4:
                    raise ValueError(
                        f"obstacle rect must be (i0, i1, j0, j1), got {r}")
                i0, i1, j0, j1 = r
                if not (1 <= i0 <= i1 <= self.i_max
                        and 1 <= j0 <= j1 <= self.j_max):
                    raise ValueError(
                        f"obstacle rect {r} outside the interior "
                        f"[1, {self.i_max}] x [1, {self.j_max}]")
        if self.obstacle_surfaces:
            if not self.obstacles:
                raise ValueError("obstacle_surfaces requires obstacles")
            arity = {"circle": 4, "box": 5, "plane": 4}
            surfs = []
            for s in self.obstacle_surfaces:
                s = tuple(s)
                if not s or s[0] not in arity:
                    raise ValueError(f"unknown obstacle surface {s!r}")
                if len(s) != arity[s[0]]:
                    raise ValueError(
                        f"obstacle surface {s!r} has wrong arity")
                vals = tuple(float(x) for x in s[1:])
                if s[0] == "circle" and vals[2] <= 0:
                    raise ValueError(f"circle radius must be > 0: {s!r}")
                if s[0] == "plane" and vals[0] == 0 and vals[1] == 0:
                    raise ValueError(f"plane normal must be nonzero: {s!r}")
                surfs.append((s[0],) + vals)
            object.__setattr__(self, "obstacle_surfaces", tuple(surfs))
        if self.obstacle_pressure not in ("auto", "staircase", "aperture"):
            raise ValueError(
                f"obstacle_pressure must be 'auto', 'staircase' or "
                f"'aperture', got {self.obstacle_pressure!r}")
        if self.obstacle_pressure == "aperture" and not self.obstacle_surfaces:
            raise ValueError(
                "obstacle_pressure='aperture' needs obstacle_surfaces")
        if not (1 <= self.mg_cycles_per_outer <= 8):
            raise ValueError(
                f"mg_cycles_per_outer must be in 1..8, got "
                f"{self.mg_cycles_per_outer}")
        if self.fft_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"fft_precision must be 'highest', 'high' or 'default', got "
                f"{self.fft_precision!r}")
        if self.outer_precision not in ("float64", "compensated"):
            raise ValueError(
                f"outer_precision must be 'float64' or 'compensated', got "
                f"{self.outer_precision!r}")
        if self.sor_inner_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"sor_inner_dtype must be 'float32' or 'bfloat16', got "
                f"{self.sor_inner_dtype!r}")

    # -- derived quantities ------------------------------------------------
    @property
    def dx(self) -> float:
        return self.a / self.i_max

    @property
    def dy(self) -> float:
        return self.b / self.j_max

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def shape(self) -> tuple:
        """Padded field shape: one ghost layer on each side."""
        return (self.i_max + 2, self.j_max + 2)

    # -- .in format round-trip ----------------------------------------------
    @classmethod
    def from_file(cls, path: str, **overrides) -> "Params":
        """Parse the reference's 15-line positional parameter format."""
        with open(path, "r") as fh:
            lines = fh.readlines()
        return cls.from_lines(lines, **overrides)

    @classmethod
    def from_lines(cls, lines, **overrides) -> "Params":
        values = {}
        if len(lines) < len(_FIELD_ORDER):
            raise ValueError(
                f"parameter file has {len(lines)} lines, need {len(_FIELD_ORDER)}"
            )
        for (name, typ), line in zip(_FIELD_ORDER, lines):
            token = line.split("#", 1)[0].split()
            if not token:
                raise ValueError(f"missing value for '{name}'")
            # int fields may be written as '500' or '500.0'
            values[name] = typ(float(token[0])) if typ is int else typ(token[0])
        optional = {5: ("Ra", "Pr"),
                    6: ("fluid_x0", "fluid_x1", "fluid_y0", "fluid_y1")}
        for name, line in zip(optional.get(values["problem"], ()),
                              lines[len(_FIELD_ORDER):]):
            token = line.split("#", 1)[0].split()
            if token:
                values[name] = float(token[0])
        values.update(overrides)
        return cls(**values)

    @classmethod
    def from_mapping(cls, mapping: Mapping) -> "Params":
        """Build from a field mapping, e.g. ``dataclasses.asdict`` of a JAX
        ``Params``.  Unknown keys raise, so a field added on one side only
        shows up as an error rather than a silent default."""
        return cls(**dict(mapping))

    def to_file(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_text())

    def to_text(self) -> str:
        out = []
        for name, typ in _FIELD_ORDER:
            val = getattr(self, name)
            sval = str(int(val)) if typ is int else repr(float(val))
            out.append(f"{sval:<12}# {_FIELD_COMMENTS[name]}")
        if self.problem == 5:
            out.append(f"{self.Ra!r:<12}# Ra: Rayleigh number (problem 5)")
            out.append(f"{self.Pr!r:<12}# Pr: Prandtl number (problem 5)")
        if self.problem == 6:
            for name, label in (("fluid_x0", "x0"), ("fluid_x1", "x1"),
                                ("fluid_y0", "y0"), ("fluid_y1", "y1")):
                out.append(f"{getattr(self, name)!r:<12}# {label}: initial "
                           f"liquid box (problem 6)")
        return "\n".join(out) + "\n"

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)
