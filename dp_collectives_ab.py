"""The data-parallel collectives of one build of the port, on the card.

Runs chip_smoke.py's 15b recipe once: two rank processes share one card
over gloo, each holding a contiguous half of ``--rows`` flagship rows
(28 features, 255 leaves, max_bin 63, wave growth), and train
``--iters`` trees through ``lightgbm_tpu_torch.train``.  It prints one
JSON line a rank: the collectives' calls, bytes and host seconds (the
comm's own counters, every collective of the run), the milliseconds a
pass (the waves and roots the run grew), the bytes a tree, the steady
it/s, the train seconds and the digest of the model text.

``--package DIR`` takes the package, and chip_smoke.py's rank function,
from another checkout (for example the parent commit unpacked by
``git archive``), so that two builds are compared on one card; run them
as parent, change, change, parent in one command::

    git archive HEAD | tar -x -C _archive/parent
    for p in _archive/parent . . _archive/parent; do
        python3 dp_collectives_ab.py --package $p; done
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=".",
                    help="the checkout whose lightgbm_tpu_torch and "
                         "chip_smoke.py run (default: this one)")
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="rows of both ranks together (15b's 2,000,000)")
    ap.add_argument("--iters", type=int, default=5,
                    help="trees (15b's 5)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the ranks are killed")
    args = ap.parse_args()
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    import chip_smoke
    from lightgbm_tpu_torch.parallel.launch import run_ranks_subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs = [{"label": "dp-2rank", "rows": args.rows, "iters": args.iters,
             "params": dict(chip_smoke.flagship_params(),
                            tree_learner="data")}]
    t0 = time.perf_counter()
    out = run_ranks_subprocess(2, "chip_smoke:phase15_rank",
                               {"runs": runs, "gen_rows": args.rows},
                               timeout=args.timeout, device="cuda")
    wall = time.perf_counter() - t0
    for o in out:
        r = o["runs"]["dp-2rank"]
        passes = max(r["passes_and_roots"], 1)
        print(json.dumps({
            "package": root, "card": card, "rank": o["rank"],
            "backend": o["backend"], "rows": r["rows"], "trees": r["trees"],
            "collective_calls": r["collective_calls"],
            "collective_bytes": r["collective_bytes"],
            "collective_s": r["collective_s"],
            "collective_ms_a_pass": 1e3 * r["collective_s"] / passes,
            "bytes_a_tree": r["collective_bytes"] / max(r["trees"], 1),
            "steady_it_s": r["steady_it_s"], "train_s": r["train_s"],
            "wall_s": wall, "digest": r["digest"]}), flush=True)


if __name__ == "__main__":
    main()
