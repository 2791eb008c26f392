#!/usr/bin/env python3
"""The JAX package's records of ``chip_smoke.py``'s brute-force requests
(``SEARCH_BF``, whose settings it reads): tinyllama-1.1b / train_4k /
V5E_POD, run by ``repro.core.optimizers.brute_force`` with
``engine="jax"`` and, as a check, ``engine="numpy"``, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/search_records.py

Prints one JSON line a request: its name, points, objective (the float64
scalar reference's value of the optimum), history [(index, objective)] and
design (cuts, s_in, s_out, kern), and whether the two engines agree
(points, design, history indices and objective). About 35 s.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    from chip_smoke import SEARCH_BF
    from repro.configs import SHAPES_BY_NAME, get_arch
    from repro.core import pipeline
    from repro.core.optimizers import brute_force
    from repro.core.platform import V5E_POD

    arch, shape = get_arch("tinyllama-1.1b"), SHAPES_BY_NAME["train_4k"]
    for req in SEARCH_BF:
        out = {}
        for engine in ("jax", "numpy"):
            problem = pipeline.make_problem(arch, shape, V5E_POD,
                                            req["backend"], req["objective"],
                                            req["exec_model"])
            t0 = time.perf_counter()
            r = brute_force(problem, engine=engine, **req["kw"])
            v = r.variables
            out[engine] = {
                "points": r.points, "value": r.evaluation.objective,
                "history": [(int(i), float(o)) for i, o in r.history],
                "variables": (list(v.cuts), list(v.s_in), list(v.s_out),
                              list(v.kern)),
                "seconds": time.perf_counter() - t0}
        j, n = out["jax"], out["numpy"]
        agree = (j["points"], j["variables"], j["value"]) == \
            (n["points"], n["variables"], n["value"]) and \
            [i for i, _ in j["history"]] == [i for i, _ in n["history"]]
        print(json.dumps({"name": req["name"], **{k: j[k] for k in (
            "points", "value", "history", "variables")},
            "engines_agree": agree, "jax_s": j["seconds"],
            "numpy_s": n["seconds"]}), flush=True)


if __name__ == "__main__":
    main()
