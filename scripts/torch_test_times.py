"""Where the time of the port's CPU tests goes: a pytest plugin and its reports.

As a plugin (``-p torch_test_times`` with ``scripts/`` on PYTHONPATH) it
writes one JSON line per test phase (setup, call, teardown) to
$TORCH_TEST_TIMES_OUT:

- the phase's seconds;
- its JAX compilations: their count, their trace / lowering / backend
  seconds (``jax.monitoring``) and, in order, each program's name and
  argument shapes (JAX's compile log) beside those seconds;
- a 100 Hz sample of the main thread's stack, each sample given to the JAX
  package (jax, jaxlib, permon_tpu, examples), the port (torch,
  permon_tpu_torch), the test file, or the rest.  The sampler holds the
  main thread's frames for a moment, so a test that checks that an object
  is freed at once (test_torch_kernel_plans.py::
  test_plan_does_not_keep_the_operator_alive) can fail under it.

With $TORCH_TEST_TIMES_CALLS=1 it writes, per test instead, each call that a
port test file makes into the JAX package or its examples, with a digest of
the arguments: two cases that run the same JAX configuration show the same
function and digest.

Reports:

    JAX_PLATFORMS=cpu TORCH_TEST_TIMES_OUT=serial.jsonl PYTHONPATH=scripts \\
        python -m pytest tests/test_torch_*.py -q -p no:randomly -p no:cacheprovider \\
        -p torch_test_times
    # the same per file, one process each, into DIR/<file>.jsonl (and with
    # TORCH_TEST_TIMES_CALLS=1 into CALLS/<file>.jsonl)
    python scripts/torch_test_times.py cases serial.jsonl [--min 3] [--files DIR] [--calls CALLS]
    python scripts/torch_test_times.py shared DIR       # programs compiled in two files
    python scripts/torch_test_times.py repeats DIR      # programs compiled twice in one file
    python scripts/torch_test_times.py junit t1.xml     # a Tier-1 run's seconds per file
    JAX_PLATFORMS=cpu python scripts/torch_test_times.py pallas   # the interpreted kernels' inputs
"""

import collections
import dataclasses
import glob
import hashlib
import json
import logging
import math
import os
import re
import sys
import threading
import time

import pytest

OUT = os.environ.get("TORCH_TEST_TIMES_OUT", "torch_test_times.jsonl")
CALLS = os.environ.get("TORCH_TEST_TIMES_CALLS") == "1"
SAMPLE_S = 0.01

_cur = {"rec": None, "calls": None}
_main = threading.get_ident()


# -- the plugin -------------------------------------------------------------------


def _new_record():
    return {"compile_n": 0, "trace_s": 0.0, "lower_s": 0.0, "backend_s": 0.0, "names": [],
            "events": [], "samples": {"jax": 0, "port": 0, "test": 0, "other": 0}}


def _on_duration(event, duration, **kw):
    r = _cur["rec"]
    if r is None:
        return
    short = event.rsplit("/", 1)[-1]
    r["events"].append((short, round(duration, 4), str(kw.get("fun_name", ""))[:80]))
    if short == "jaxpr_trace_duration":
        r["trace_s"] += duration
    elif short == "jaxpr_to_mlir_module_duration":
        r["lower_s"] += duration
    elif short == "backend_compile_duration":
        r["backend_s"] += duration
        r["compile_n"] += 1


class _CompileLog(logging.Handler):
    def emit(self, record):
        r = _cur["rec"]
        msg = record.getMessage() if r is not None else ""
        if msg.startswith("Compiling "):
            name = msg[len("Compiling "):].split(". Argument mapping")[0][:300]
            r["names"].append(name)
            r["events"].append(("log", 0.0, name))


def _side(frame):
    while frame is not None:
        f = frame.f_code.co_filename
        if "/permon_tpu_torch/" in f or "/torch/" in f:
            return "port"
        if "/permon_tpu/" in f or "/jax/" in f or "/jaxlib/" in f or "/examples/" in f:
            return "jax"
        if "/tests/test_torch_" in f:
            return "test"
        frame = frame.f_back
    return "other"


def _sampler():
    while True:
        time.sleep(SAMPLE_S)
        r = _cur["rec"]
        frame = sys._current_frames().get(_main) if r is not None else None
        if frame is not None:
            r["samples"][_side(frame)] += 1
        del frame


def _digest(x, depth=0):
    """A digest of an argument: arrays by shape, dtype and bytes, containers
    and dataclasses by their fields, functions by name."""
    import numpy as np

    if depth > 4:
        return type(x).__name__
    if hasattr(x, "tocsr") and hasattr(x, "indices"):
        x = x.tocsr()
        return f"sp{x.shape}:" + hashlib.md5(np.ascontiguousarray(x.data).tobytes()
                                              + np.ascontiguousarray(x.indices).tobytes()
                                              ).hexdigest()[:8]
    if isinstance(x, (int, float, str, bool, complex, type(None), np.generic)):
        return repr(x)
    if isinstance(x, np.ndarray) or type(x).__module__.startswith("jax") or \
            type(x).__name__ in ("ArrayImpl", "Tensor"):
        try:
            a = np.ascontiguousarray(np.asarray(x))
        except Exception:
            return type(x).__name__
        return f"a{a.shape}{a.dtype}:" + hashlib.md5(a.tobytes()).hexdigest()[:8]
    if isinstance(x, (list, tuple)):
        return "[" + ",".join(_digest(v, depth + 1) for v in x[:50]) + "]"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{_digest(v, depth + 1)}" for k, v in list(x.items())[:50]) + "}"
    if callable(x) and hasattr(x, "__qualname__"):
        return "fn:" + x.__qualname__
    if dataclasses.is_dataclass(x):
        return type(x).__name__ + "(" + ",".join(
            f"{f.name}={_digest(getattr(x, f.name, None), depth + 1)}"
            for f in dataclasses.fields(x)) + ")"
    d = getattr(x, "__dict__", None)
    return type(x).__name__ + (_digest(d, depth + 1) if d is not None else "")


def _profile(frame, event, arg):
    if event != "call" or _cur["calls"] is None:
        return
    back = frame.f_back
    f = frame.f_code.co_filename
    if back is None or "/tests/test_torch_" not in back.f_code.co_filename or \
            "permon_tpu_torch" in f or not ("/permon_tpu/" in f or "/examples/" in f):
        return
    code = frame.f_code
    nargs = code.co_argcount + code.co_kwonlyargcount + bool(code.co_flags & 0x04) + \
        bool(code.co_flags & 0x08)  # *args, **kwargs
    args = {n: frame.f_locals.get(n) for n in code.co_varnames[:nargs]}
    where = f.split("/permon_tpu/")[-1] if "/permon_tpu/" in f else \
        "examples/" + f.split("/examples/")[-1]
    try:
        dig = hashlib.md5(_digest(args).encode()).hexdigest()[:12]
    except Exception as exc:
        dig = f"error {exc}"
    _cur["calls"].append({"fn": f"{where}::{code.co_qualname}", "fp": dig})


def pytest_configure(config):
    if CALLS:
        return
    import jax.monitoring

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    log = logging.getLogger("jax._src.interpreters.pxla")
    log.setLevel(logging.DEBUG)
    log.addHandler(_CompileLog())
    log.propagate = False
    threading.Thread(target=_sampler, daemon=True).start()


def _write(line):
    with open(OUT, "a") as f:
        f.write(json.dumps(line) + "\n")


def _phase(item, phase):
    if CALLS:
        yield
        return
    r = _new_record()
    _cur["rec"] = r
    t0 = time.perf_counter()
    yield
    r["wall_s"] = time.perf_counter() - t0
    _cur["rec"] = None
    _write(dict(r, id=item.nodeid, phase=phase))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _phase(item, "setup")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _phase(item, "call")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    yield from _phase(item, "teardown")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if not CALLS:
        yield
        return
    _cur["calls"] = []
    sys.setprofile(_profile)
    t0 = time.perf_counter()
    yield
    sys.setprofile(None)
    _write({"id": item.nodeid, "wall": time.perf_counter() - t0, "calls": _cur["calls"]})
    _cur["calls"] = None


# -- the reports ----------------------------------------------------------------

_SINGLE_OPS = re.compile(r"^jit\((broadcast_in_dim|convert_element_type|iota)\)")
_SHAPE = re.compile(r"(float64|float32|bfloat16|int16|int32|int64|bool)\[([0-9,]*)\]")


def _load(path):
    cases = collections.defaultdict(dict)
    for line in open(path):
        r = json.loads(line)
        cases[r["id"]][r["phase"]] = r
    return cases


def _compiles(rec):
    """(program, seconds) of each compilation in a phase record, in order:
    the program's name and its largest argument."""
    out, last, pending = [], None, 0.0
    for ev, dur, name in rec["events"]:
        if ev == "log":
            last = name
        elif ev != "backend_compile_duration":
            pending += dur
        else:
            prog, _, shapes = (last or name).partition(" with global shapes and types ")
            found = _SHAPE.findall(shapes)
            if found:
                dt, dims = max(found, key=lambda t: math.prod(int(d) for d in t[1].split(",") if d))
                prog += f" {dt}[{dims}]"
            out.append((prog, dur + pending))
            pending = 0.0
    return out


def report_cases(path, least=3.0, files=None, calls=None):
    """The table of every case over ``least`` seconds."""
    cases = _load(path)
    top = {}
    for p in glob.glob(os.path.join(files, "*.jsonl")) if files else ():
        per = collections.defaultdict(collections.Counter)
        for tid, phases in _load(p).items():
            for rec in phases.values():
                for prog, s in _compiles(rec):
                    per[tid][prog] += s
        top.update({tid: c.most_common(3) for tid, c in per.items()})
    entries = {}
    for p in glob.glob(os.path.join(calls, "*.jsonl")) if calls else ():
        for line in open(p):
            r = json.loads(line)
            names = []
            for c in r["calls"]:
                where, fn = c["fn"].split("::")
                short = os.path.basename(where)[:-3] + "." + fn
                skip = ("Options", "Tolerances", "__", ".shape", ".ns", ".nl", "replace",
                        ".build", "build_")
                if not any(k in short for k in skip) and short not in names:
                    names.append(short)
            entries[r["id"]] = names
    rows = []
    for tid, ph in cases.items():
        total = sum(p["wall_s"] for p in ph.values())
        comp = sum(p["trace_s"] + p["lower_s"] + p["backend_s"] for p in ph.values())
        samples = collections.Counter()
        for p in ph.values():
            samples.update(p["samples"])
        n = sum(samples.values()) or 1
        rows.append(dict(
            id=tid, total=total, setup=ph.get("setup", {}).get("wall_s", 0.0),
            call=ph.get("call", {}).get("wall_s", 0.0),
            compiles=sum(p["compile_n"] for p in ph.values()), compile_s=comp,
            jax_run_s=max(samples["jax"] / n * total - comp, 0.0),
            port_s=samples["port"] / n * total,
            entries=", ".join(entries.get(tid, [])[:4]) or "(fixture)",
            programs="; ".join(f"{k} {v:.1f}" for k, v in top.get(tid, []))))
    rows.sort(key=lambda r: -r["total"])
    big = [r for r in rows if r["total"] > least]
    print("| Case | setup s | call s | compiles | compile s | JAX run s | port s | "
          "JAX entry called | costliest programs, s |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in big:
        print(f"| `{r['id'].replace('tests/test_torch_', '')}` | {r['setup']:.1f} | "
              f"{r['call']:.1f} | {r['compiles']} | {r['compile_s']:.1f} | "
              f"{r['jax_run_s']:.1f} | {r['port_s']:.1f} | {r['entries']} | {r['programs']} |")
    print(f"\n{len(big)} cases over {least} s: {sum(r['total'] for r in big):.0f} s of "
          f"{sum(r['total'] for r in rows):.0f} s; compiles {sum(r['compile_s'] for r in big):.0f} s,"
          f" JAX runs {sum(r['jax_run_s'] for r in big):.0f} s, port "
          f"{sum(r['port_s'] for r in big):.0f} s")


def _programs_by_file(folder):
    files = {}
    for p in sorted(glob.glob(os.path.join(folder, "*.jsonl"))):
        progs = collections.defaultdict(list)
        for tid, phases in _load(p).items():
            for rec in phases.values():
                last = None
                for ev, dur, name in rec["events"]:
                    if ev == "log":
                        last = name
                    elif ev == "backend_compile_duration":
                        progs[last or name].append((dur, tid.split("::")[1]))
        files[os.path.basename(p)[len("test_torch_"):-len(".jsonl")]] = progs
    return files


def report_shared(folder):
    """Programs (name and argument shapes) compiled in more than one file's
    own process, with the seconds a second file pays for them."""
    files = _programs_by_file(folder)
    pair = collections.Counter()
    for prog in {k for progs in files.values() for k in progs}:
        if _SINGLE_OPS.match(prog):
            continue
        owners = sorted((sum(d for d, _ in progs[prog]), f) for f, progs in files.items()
                        if prog in progs)
        for i, (si, fi) in enumerate(owners):
            for sj, fj in owners[i + 1:]:
                pair[tuple(sorted((fi, fj)))] += min(si, sj)
    for (a, b), s in pair.most_common(20):
        print(f"{a} + {b}: {s:.1f} s compiled in both")


def report_repeats(folder):
    """Programs of one name and argument shapes compiled more than once in
    one file's process (fresh closures, or static arguments the log does
    not show)."""
    for f, progs in _programs_by_file(folder).items():
        rep = sum(sum(d for d, _ in v[1:]) for v in progs.values() if len(v) > 1)
        print(f"{f}: {rep:.1f} s of repeated compilations")


def report_junit(path):
    import xml.etree.ElementTree as ET

    per = collections.Counter()
    mid = None
    for tc in ET.parse(path).getroot().iter("testcase"):
        f = tc.get("classname", "").split(".")
        name = "/".join(f[:2]) + ".py" if len(f) > 1 else f[0]
        per[name] += float(tc.get("time", 0))
        if tc.get("name") == "test_northstar_twin_sharded_midsize":
            mid = float(tc.get("time", 0))
    port = sum(v for k, v in per.items() if "test_torch_" in k)
    large = per["tests/test_large.py"]
    print(f"port files {port:.1f} s, test_large.py {large:.1f} s (midsize case {mid} s), "
          f"other JAX files {sum(per.values()) - port - large:.1f} s")
    for k, v in per.most_common():
        if "test_torch_" in k:
            print(f"  {k} {v:.1f}")


def report_pallas():
    """What the interpreted Pallas oracles of tests/test_torch_sell.py and
    tests/test_torch_kernels.py compile: per input its rounds, grid steps,
    window and tiles, and the seconds of its first call in this process
    (an input whose static configuration an earlier one compiled reuses it)."""
    sys.path[:0] = [".", "tests"]
    import tests.conftest  # noqa: F401  (the tests' JAX settings)
    import jax.numpy as jnp
    import numpy as np

    import test_torch_sell as ts
    from examples.feti_large import build_sparse
    from permon_tpu.core.extension import SubdomainExtension
    from permon_tpu.core.sell import RB, SEll, _sell_mv_pallas
    from permon_tpu.feti.assembly import build_gluing

    for name, make in ts.MATRICES.items():
        a = make()
        op = SEll.from_scipy(a, with_transpose=True)
        x = np.random.RandomState(2).rand(a.shape[1]).astype(np.float32)
        t0 = time.perf_counter()
        _sell_mv_pallas(op.wstart, op.tid, op.SC, op.V.astype(jnp.float32),
                        op._x2d(jnp.asarray(x)), op.ntiles, op.win // 128,
                        interpret=True).block_until_ready()
        nr = op.V.shape[0]
        print(f"sell {name} {a.shape}: rounds {nr}, grid steps {nr // RB}, window {op.win}, "
              f"tiles {op.ntiles}: {time.perf_counter() - t0:.2f} s")
    prob = build_sparse((6, 6, 6), (2, 2, 2))
    r, c, v, m = build_gluing(prob.l2g, "nonred", True)
    B = SubdomainExtension.from_coo(r, c, v, m=m, ns=prob.ns, nl=prob.nl).with_gather_apply()
    Bs = B.with_sell_gather()
    for nm in ("sB", "sBt"):
        s = getattr(Bs, nm)
        print(f"gather {nm} (6^3 on 2^3, nonred): rounds {s.tid.shape[0]}, grid steps "
              f"{s.tid.shape[0] // RB}, window {s.win}, tiles {s.ntiles}")
    Bs = Bs.replace(sB=Bs.sB.replace(use_pallas=True, interpret=True),
                    sBt=Bs.sBt.replace(use_pallas=True, interpret=True))
    for nm, fn, n in (("mv", Bs.mv, B.ns * B.nl), ("rmv", Bs.rmv, B.m_dual)):
        t0 = time.perf_counter()
        np.asarray(fn(jnp.asarray(np.random.RandomState(0).randn(n))))
        print(f"gather {nm}: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    import argparse

    if sys.argv[1:] == ["pallas"]:
        report_pallas()
        sys.exit(0)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("report", choices=["cases", "shared", "repeats", "junit"])
    ap.add_argument("path")
    ap.add_argument("--min", type=float, default=3.0)
    ap.add_argument("--files")
    ap.add_argument("--calls")
    a = ap.parse_args()
    if a.report == "cases":
        report_cases(a.path, a.min, a.files, a.calls)
    elif a.report == "shared":
        report_shared(a.path)
    elif a.report == "repeats":
        report_repeats(a.path)
    else:
        report_junit(a.path)
