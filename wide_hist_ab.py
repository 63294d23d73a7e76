"""The histogram kernels of one build of the port at wide bins, on the card.

Bins the flagship rows (``chip_smoke.make_data``, 28 features) at
``max_bin`` 63 (the main path), 255 (byte bins) and 1023 (uint16 bins),
and on each times B1 and B3 at a wave of K = W = 32 slots
(``chip_smoke.wave_state``), B3 at the root (K = 1), B4 at K = 32 and B5
on one leaf (at 63 bins also B1, B3 and B4 on float64 weights, the f64
form of ``tpu_use_dp``), as ``chip_smoke.py`` phase 13 times them
(``time_ms``: runs of 20 back-to-back launches between one pair of CUDA
events, median of 5).  Each kernel's line carries its plan
(``hist_plan``) and the SHA-256 of its histogram, so that two builds'
histograms can be held to the bit.  Then it trains ``chip_smoke.py`` 13d's recipe
(the flagship at ``max_bin`` 1023 on its first 1,000,000 rows, 5
iterations, fused) on ``auto`` (B3) and ``pallas_ct`` (B1), and prints
the steady it/s and the digest of each model text (its
``drift_fingerprint=`` line dropped).  One JSON line a measurement.
``--profile`` adds each kernel call's device time by CUDA kernel (the
list passes, the histogram pass, the conversion, the memset), from
``torch.profiler`` over 10 calls.

``--package DIR`` takes the package and chip_smoke.py's helpers from
another checkout (for example the parent commit unpacked by ``git
archive``), so that two builds are compared on one card; run them as
parent, change, change, parent in one command::

    git archive HEAD~1 | tar -x -C _archive/parent
    for p in _archive/parent . . _archive/parent; do
        python3 wide_hist_ab.py --package $p; done
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def device_us(fn, calls=10):
    """{CUDA kernel: microseconds of device time a call} over `calls`
    calls of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=".",
                    help="the checkout whose lightgbm_tpu_torch and "
                         "chip_smoke.py run (default: this one)")
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="rows the kernels are timed on")
    ap.add_argument("--train-rows", type=int, default=1_000_000,
                    help="rows of the max_bin 1023 training runs (13d's)")
    ap.add_argument("--bins", default="63,255,1023",
                    help="the max_bin values the kernels are timed at")
    ap.add_argument("--profile", action="store_true",
                    help="also each call's device time by CUDA kernel")
    args = ap.parse_args()
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import leaf_hist as lh
    from lightgbm_tpu_torch.ops import wave_kernels as wk
    if not torch.cuda.is_available():
        sys.exit("wide_hist_ab.py: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    X, y = cs.make_data(max(args.rows, args.train_rows) + 200_000)

    def emit(**kw):
        print(json.dumps(dict(package=root, card=card, **kw)), flush=True)

    K = 32
    for max_bin in (int(b) for b in args.bins.split(",")):
        t0 = time.perf_counter()
        ds = lgb.Dataset(X[:args.rows], label=y[:args.rows],
                         params=dict(cs.flagship_params(), max_bin=max_bin)
                         ).construct()
        td = ds._handle
        X_t = cs.bins_t_of(ds)
        F, N = X_t.shape
        B = int(td.num_bin_arr.max())
        g = torch.Generator(device="cpu").manual_seed(13)
        lid, w3, cols, psrc, cid = (t.to(dev) for t in cs.wave_state(
            N, F, B, K, torch.as_tensor(td.default_bin_arr), g))
        exps = wk.fixed_point_exponents(w3)
        Xr = X_t.t().contiguous()
        new_lid, _ = wk.wave_partition_hist(X_t, lid, w3, cid, cols, psrc,
                                            B, exps=exps)
        zeros = torch.zeros(N, dtype=torch.int32, device=dev)
        root_id = torch.zeros(1, dtype=torch.int32, device=dev)
        leaf = cid[:1]
        listed = int(sum(int((new_lid == c).sum()) for c in cid.tolist()
                         if c >= 0))
        bb = X_t.element_size()

        def bound(name, k, rows):
            """chip_smoke.py phase 13's bound of a call: its leaf ids
            (and B1's routing inputs and new ids), each listed row's bins
            and weights once, the histogram out; 3 adds a (row,
            feature)."""
            wb = 24 if "f64" in name else 12
            ids = (N * (4 + 4 + bb) + K * (10 * 4 + 8) if name.startswith(
                "B1") else N * 4 + k * 4)
            return cs.bound(ids + rows * (F * bb + wb) + k * F * B * wb,
                            3 * rows * F)[0]
        w64 = w3.double()
        e64 = wk.fixed_point_exponents(w64)
        calls = {
            "B1": (K, lambda: wk.wave_partition_hist(
                X_t, lid, w3, cid, cols, psrc, B, exps=exps)[1]),
            "B3": (K, lambda: wk.wave_histogram(X_t, new_lid, w3, cid, B,
                                                exps=exps)),
            "B3 root": (1, lambda: wk.wave_histogram(X_t, zeros, w3,
                                                     root_id, B, exps=exps)),
            "B4": (K, lambda: wk.wave_histogram_rowmajor(
                Xr, new_lid, w3, cid, B, exps=exps)),
            "B5 leaf": (1, lambda: lh.leaf_histogram(
                Xr, None, None, new_lid, leaf, None, B, w3=w3, exps=exps)),
        }
        if max_bin == 63:
            calls.update({
                "B1 f64": (K, lambda: wk.wave_partition_hist(
                    X_t, lid, w64, cid, cols, psrc, B, exps=e64)[1]),
                "B3 f64": (K, lambda: wk.wave_histogram(
                    X_t, new_lid, w64, cid, B, exps=e64)),
                "B4 f64": (K, lambda: wk.wave_histogram_rowmajor(
                    Xr, new_lid, w64, cid, B, exps=e64))})
        for name, (k, fn) in calls.items():
            h = fn()
            torch.cuda.synchronize()
            plan = wk.hist_plan(F, N, B, k, sms, False, "f64" in name)
            rows = (listed if k == K else N if name == "B3 root"
                    else int((new_lid == leaf).sum()))
            emit(max_bin=max_bin, B=B, dtype=str(X_t.dtype), N=N, F=F, K=k,
                 kernel=name, ms=cs.time_ms(fn), plan=list(plan),
                 listed_rows=rows, bound_ms=bound(name, k, rows),
                 hist_digest=digest(h),
                 device_us=device_us(fn) if args.profile else None)
            del h
        del X_t, Xr, ds, td
        torch.cuda.empty_cache()
        emit(max_bin=max_bin, phase_s=time.perf_counter() - t0)

    # 13d's recipe: the flagship at max_bin 1023 on its first rows, fused
    n = args.train_rows
    p1023 = dict(cs.flagship_params(), max_bin=1023)
    ds = lgb.Dataset(X[:n], label=y[:n], params=p1023).construct()
    Xv, yv = X[-200_000:], y[-200_000:]
    dv = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    for mode in ("auto", "pallas_ct"):
        stamps = []

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        t0 = time.perf_counter()
        booster = lgb.train(dict(p1023, tpu_histogram_mode=mode), ds, 5,
                            valid_sets=[dv], callbacks=[stamp])
        torch.cuda.synchronize()
        text = "".join(ln for ln in booster.model_to_string().splitlines(
            keepends=True) if not ln.startswith("drift_fingerprint="))
        emit(train=mode, rows=n, max_bin=1023,
             steady_it_s=(len(stamps) - 1) / (stamps[-1] - stamps[0]),
             train_s=time.perf_counter() - t0,
             text_digest=hashlib.sha256(text.encode()).hexdigest()[:16])
        del booster
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
