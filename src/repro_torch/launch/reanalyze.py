"""Re-run the op accounting over saved dry-run traces (no new trace), as
the JAX package's ``launch/reanalyze.py`` re-reads saved HLO.

Tracing is the slow part, and the accounting rules evolve; this rewrites
each ``<cell>.json``'s ``ops``, the memory terms its trace gives, ``fits``
and ``roofline`` from the ``<cell>.ops.json.gz`` saved beside it.

  PYTHONPATH=src python -m repro_torch.launch.reanalyze [dir]
"""
import glob
import json
import os
import sys

from repro_torch.launch import dryrun, op_analysis


def reanalyze_dir(d: str) -> int:
    n = 0
    for jpath in sorted(glob.glob(os.path.join(d, "*.json"))):
        tpath = jpath[:-5] + ".ops.json.gz"
        if not os.path.exists(tpath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        stats = op_analysis.analyze(op_analysis.load_trace(tpath),
                                    world=rec["world"])
        dryrun.apply_stats(rec, stats)
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    return n


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    target = argv[0] if argv else os.path.abspath(dryrun.RESULTS_DIR)
    print(f"re-analyzed {reanalyze_dir(target)} records under {target}")


if __name__ == "__main__":
    main()
