"""Options database — the port of :mod:`permon_tpu.sys.options` (the
PETSc/PERMON prefixed string-options analog).

The reference configures every object through hierarchically prefixed string
options (`-qps_rtol`, `-qps_mpgp_gamma`, `-dual_pc_dual_type`,
`-feti_gluing_type`, ...), read from rc files (~/.permonrc, ./permonrc,
./.permonrc — lowest precedence first) and the command line
(PermonInitialize, src/sys/permoninit.c:36-93; PermonProcessInfoExclusions
src/sys/utils.c:76-104).

Here the same surface maps onto the library's option dataclasses: an
:class:`Options` object holds a flat {key: value} dict with the reference's
key spelling, loads rc files and argv, and :func:`solve_from_options` drives
``permon_tpu_torch.solve`` from it — the QPSSetFromOptions / QPTFromOptions analog.

Recognized keys (reference option -> effect):
- qps_type                 -> solver selection (mprgp/smalxe/cg/pcpg/tao)
- qps_rtol/atol/divtol/max_it -> Tolerances
- qps_mpgp_gamma/alpha/alpha_user/expansion_type/expansion_length_type/
  btol/bound_chop_tol       -> MPRGPOptions
- qps_smalxe_M1/eta/rho/rho_update/rho_update_late/M1_update/knoll ...
                            -> SMALXEOptions
- qps_tao_type              -> tao adapter type
- feti_gluing_type, dual_pc_dual_type, dual_qp_E_orth_type, feti_throughput,
  feti_precision, ...       -> FetiOptions (feti_options_from_options)
- permon_debug/trace/info   -> sys.tracing flags

The rc files are read from the home and the working directory; pass
``rc=False`` to read argv alone.  The solve runs where the QP lies.
"""

from __future__ import annotations

import os
import shlex
from typing import Any, Dict, Optional, Sequence

from . import tracing

RC_FILES = ("~/.permonrc", "./permonrc", "./.permonrc")


def _parse_value(s: str) -> Any:
    low = s.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


class Options:
    """Flat key->value store with reference-style option keys."""

    def __init__(self, **kwargs):
        self.db: Dict[str, Any] = dict(kwargs)

    @classmethod
    def from_args(cls, args: Optional[Sequence[str]] = None, rc: bool = True) -> "Options":
        """PermonInitialize analog: rc files (lowest precedence) then argv.

        Tokens look exactly like the reference CLI: ``-qps_rtol 1e-6
        -qps_type mpgp -permon_trace``."""
        opts = cls()
        if rc:
            for path in RC_FILES:
                p = os.path.expanduser(path)
                if os.path.exists(p):
                    with open(p) as f:
                        opts.update_from_tokens(shlex.split(f.read(), comments=True))
        if args is None:
            import sys as _sys

            args = _sys.argv[1:]
        opts.update_from_tokens(list(args))
        tracing.set_from_options(
            debug=opts.db.get("permon_debug"),
            trace=opts.db.get("permon_trace"),
            info=opts.db.get("permon_info"),
        )
        return opts

    def update_from_tokens(self, tokens: Sequence[str]) -> None:
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            if not tok.startswith("-"):
                i += 1
                continue
            key = tok.lstrip("-")
            if i + 1 < len(tokens) and not tokens[i + 1].startswith("-"):
                self.db[key] = _parse_value(tokens[i + 1])
                i += 2
            else:
                self.db[key] = True  # bare flag
                i += 1

    def get(self, key: str, default: Any = None) -> Any:
        return self.db.get(key, default)

    def sub(self, prefix: str) -> Dict[str, Any]:
        """All options under a prefix, with the prefix stripped — the
        object-prefix composition idiom (e.g. prefix 'qps_mpgp_')."""
        n = len(prefix)
        return {k[n:]: v for k, v in self.db.items() if k.startswith(prefix)}


def tolerances_from_options(opts: Options):
    from ..core.convergence import Tolerances

    t = Tolerances()
    return Tolerances(
        rtol=float(opts.get("qps_rtol", t.rtol)),
        atol=float(opts.get("qps_atol", t.atol)),
        divtol=float(opts.get("qps_divtol", t.divtol)),
        max_it=int(opts.get("qps_max_it", t.max_it)),
    )


def feti_options_from_options(opts: Options):
    """Map reference-style FETI option keys onto :class:`FetiOptions`
    (QPFetiSetFromOptions + the dualize/orth prefixes):

    -feti_gluing_type {nonred|full|orth}      (qpfeti.c:322)
    -dual_pc_dual_type {none|lumped}          (pcdual.c)
    -dual_qp_E_orth_type {gs|gslingen|cholesky|implicit|inexact}
                                              (permonmatorth.c:6)
    -project {0|1}, -feti_scale, -feti_precision {f64|mixed|f32}
    """
    from ..feti.solve import FetiOptions

    fo = FetiOptions()
    orth = opts.get("dual_qp_E_orth_type", fo.orth_G)
    if orth == "gslingen":  # the MatOrthTypes[] string for MAT_ORTH_GS_LINGEN
        orth = "gs_lingen"
    return FetiOptions(
        gluing=str(opts.get("feti_gluing_type", fo.gluing)),
        scale=bool(opts.get("feti_scale", fo.scale)),
        project=bool(opts.get("project", fo.project)),
        pc_dual=str(opts.get("dual_pc_dual_type", fo.pc_dual)),
        orth_G=orth,
        nullspace=str(opts.get("feti_nullspace", fo.nullspace)),
        throughput=bool(opts.get("feti_throughput", fo.throughput)),
        precision=str(opts.get("feti_precision", fo.precision)),
        # -dual_qppf_redundancy N: the reference distributes the coarse
        # factor over N subcommunicator groups; any nonzero value selects
        # the host-group distributed factor on a two-axis mesh
        # (parallel/coarse.py); without a mesh it is ignored
        qppf_redundancy=bool(int(opts.get("dual_qppf_redundancy", 0))),
    )


def solve_from_options(qp, opts: Options, **extra):
    """QPSSetFromOptions + QPSSolve: pick type and per-solver options from
    the database and run (qps.c:422-455 default-type rule applies when
    -qps_type is absent)."""
    from ..solvers.driver import solve

    tol = tolerances_from_options(opts)
    qps_type = opts.get("qps_type")
    kwargs: Dict[str, Any] = dict(extra)
    if (qps_type or "mpgp") in ("mpgp", "mprgp"):
        from ..solvers.mprgp import MPRGPOptions

        mo = MPRGPOptions()
        sub = opts.sub("qps_mpgp_")
        fields = {f for f in mo.__dataclass_fields__}  # type: ignore[attr-defined]
        mpgp_kwargs = {k: v for k, v in sub.items() if k in fields}
        if mpgp_kwargs and (qps_type in ("mpgp", "mprgp") or qps_type is None):
            kwargs["opts"] = MPRGPOptions(**mpgp_kwargs)
    if qps_type == "smalxe" or (qps_type is None and qp.BE is not None):
        from ..solvers.smalxe import SMALXEOptions

        so = SMALXEOptions()
        sub = opts.sub("qps_smalxe_")
        fields = {f for f in so.__dataclass_fields__}  # type: ignore[attr-defined]
        sm = {k: v for k, v in sub.items() if k in fields}
        if sm:
            kwargs["opts"] = SMALXEOptions(**sm)
    if qps_type == "tao":
        kwargs.setdefault("tao_type", opts.get("qps_tao_type", "gpcg"))
    if qps_type in ("mpgp",):
        qps_type = "mprgp"
    return solve(qp, qps_type=qps_type, tol=tol, **kwargs)
