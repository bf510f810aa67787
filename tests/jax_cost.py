"""Where the tier-1 suite's time goes: JAX's tracing, lowering and XLA
compiles per test, and the cost of one reference compile at XLA's default
optimization and at -O0.

As a pytest plugin, with ``tests`` on the path::

    JAX_COST_OUT=/tmp/cost PYTHONPATH=tests python -m pytest tests/ \\
        -p jax_cost -n 6 --dist load ...

each worker appends one JSON line a test to ``$JAX_COST_OUT.<pid>.jsonl``:
its wall seconds, its start, and the seconds and counts of JAX's
monitoring events during it (``jaxpr_trace_duration``,
``jaxpr_to_mlir_module_duration``, ``backend_compile_duration``; nested
traces count once each, so traces overlap), and one line for every
executable written to the persistent cache.  Then::

    python tests/jax_cost.py summary /tmp/cost      # totals, workers' ends
    python tests/jax_cost.py compile                # one compile, O2 vs O0
"""
import collections
import glob
import json
import os
import sys
import time

import pytest

OUT = os.environ.get("JAX_COST_OUT")
EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
          "/jax/core/compile/jaxpr_to_mlir_module_duration",
          "/jax/core/compile/backend_compile_duration")
_test = {"id": None}
_sums = collections.defaultdict(collections.Counter)
_file = []


def _write(rec):
    if not _file:
        _file.append(open(f"{OUT}.{os.getpid()}.jsonl", "a", buffering=1))
    _file[0].write(json.dumps(rec) + "\n")


def pytest_configure(config):
    if not OUT:
        return
    from jax._src import compiler, monitoring

    def on_duration(event, secs, **_):
        if event in EVENTS:
            _sums[_test["id"]][event] += secs
            _sums[_test["id"]][event + "#n"] += 1

    monitoring.register_event_duration_secs_listener(on_duration)
    write_cache = compiler._cache_write

    def on_cache_write(key, secs, module_name, *args, **kw):
        _write({"test": _test["id"], "cache_write": module_name,
                "key": key[-16:], "s": secs})
        return write_cache(key, secs, module_name, *args, **kw)

    compiler._cache_write = on_cache_write


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    _test["id"] = item.nodeid
    t0 = time.time()
    yield
    if OUT:
        _write({"test": item.nodeid, "t0": t0, "wall": time.time() - t0,
                "events": dict(_sums.pop(item.nodeid, {}))})


def summary(prefix):
    """Summed seconds of the port's tests and the JAX package's, by
    event; each worker's busy seconds and end; compiles that repeat."""
    tests, writes = collections.defaultdict(list), []
    for path in glob.glob(prefix + ".*.jsonl"):
        for line in open(path):
            rec = json.loads(line)
            (writes.append(rec) if "cache_write" in rec
             else tests[path].append(rec))
    start = min(r["t0"] for rs in tests.values() for r in rs)
    for side in ("test_torch_", "test_"):
        rs = [r for v in tests.values() for r in v
              if r["test"].startswith("tests/" + side)
              and (side == "test_torch_" or "test_torch_" not in r["test"])]
        print(side, "wall", round(sum(r["wall"] for r in rs), 1), {
            e.rsplit("/", 1)[1]: round(sum(r["events"].get(e, 0)
                                           for r in rs), 1) for e in EVENTS})
    for path, rs in sorted(tests.items()):
        print(path.rsplit(".", 2)[1], "busy",
              round(sum(r["wall"] for r in rs)), "ends",
              round(max(r["t0"] + r["wall"] for r in rs) - start))
    big = [w for w in writes if w["s"] >= 0.5]
    keys = collections.Counter(w["key"] for w in big)
    print("compiles of >= 0.5 s:", len(big), "seconds",
          round(sum(w["s"] for w in big), 1), "repeated keys",
          sum(1 for n in keys.values() if n > 1))


def compile_cost():
    """The PRB gradient of cornell_box(16, 4, 3) compiled at XLA's default
    and under ``jax_disable_most_optimizations``: wall and CPU seconds,
    and how far the gradients move."""
    import resource

    import jax
    import jax.numpy as jnp
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    import epsm_mitsuba3_tpu as mi
    from epsm_mitsuba3_tpu.ad import prb
    from scenes import cornell_box

    jax.config.update("jax_platforms", "cpu")
    sj = mi.load_dict(cornell_box(res=16, spp=4, max_depth=3))
    W = np.random.default_rng(0).uniform(0, 1, (16, 16, 3)).astype(
        np.float32)
    lowered = jax.jit(jax.grad(lambda s: jnp.sum(prb.render_prb(
        s, 0, sensor_idx=0, spp=4, max_depth=3) * W), allow_int=True)
    ).lower(sj)

    def cpu():
        r = resource.getrusage(resource.RUSAGE_SELF)
        return r.ru_utime + r.ru_stime

    ref = None
    for o0 in (False, True):
        t, c = time.time(), cpu()
        exe = lowered.compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True} if o0 else None)
        wall, secs = time.time() - t, cpu() - c
        out = [np.asarray(x, np.float64) for x in jax.tree.leaves(exe(sj))
               if np.asarray(x).dtype.kind == "f"]
        ref = ref or out
        print("O0" if o0 else "default", "compile wall", round(wall, 2),
              "cpu", round(secs, 2), "max |diff|",
              max(float(np.abs(a - b).max()) for a, b in zip(out, ref)))


if __name__ == "__main__":
    if sys.argv[1] == "summary":
        summary(sys.argv[2])
    else:
        compile_cost()
