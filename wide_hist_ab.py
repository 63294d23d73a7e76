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

``--b5`` times B5 alone instead, in every form on the flagship's
row-major bins (byte at ``max_bin`` 63 and 255, uint16 at 1023, f64 at
63, the deferred form at 63) at four leaf sizes (no row, ~N/4096, ~N/64,
the root), and the finish (``finish_hist``) at 63 bins, each in two
readings: ``time_ms`` as above, and the replay reading (``replay_ms``: 20
calls captured in one CUDA graph, timed over its replays between one
event pair, median of 5), which leaves out the wrapper's host work.  For
the one-scan kernel it also times B4's chain at K = 1 on the same
inputs (the plan it replaces, and what B5 keeps past what one block
holds).  Then it trains exact growth fused, 5 iterations, on the
flagship at ``max_bin`` 63 (``--rows``), at 1023 (13d's exact run,
``--train-rows``) and with ``tpu_use_dp`` at 63 (13e's dp-exact,
``--train-rows``), and prints each steady it/s and text digest; with
``--profile`` also one more iteration's device time, B5's part of it
(its kernels and memsets: the one-scan kernel and its conversion, or
B4's chain) and the largest kernels, from ``torch.profiler``.

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


def replay_ms(fn, calls=20, replays=5):
    """Milliseconds a call of fn() as the device runs it: `calls` calls
    captured in one CUDA graph (after a warm-up on a side stream), the
    graph replayed between one pair of CUDA events, median of `replays`
    replays, divided by the calls."""
    import statistics

    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(runs)


def b5_cases(args, cs, lgb, lh, wk, X, y, emit):
    """B5 in every form at four leaf sizes, and the finish, in both
    readings (the module docstring's ``--b5``)."""
    import torch
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    N = args.rows
    g = torch.Generator(device="cpu").manual_seed(21)
    lid = torch.randint(3, 64, (N,), generator=g, dtype=torch.int32)
    lid[torch.randperm(N, generator=g)[:N // 64]] = 1
    lid[torch.randperm(N, generator=g)[:N // 4096]] = 2
    lid = lid.to(dev)
    roots = torch.zeros(N, dtype=torch.int32, device=dev)
    grad = torch.randn(N, generator=g).to(dev)
    hess = (torch.rand(N, generator=g) + 0.05).to(dev)
    bag = (torch.rand(N, generator=g) > 0.2).float().to(dev)
    w32 = torch.stack([grad * bag, hess * bag, bag], dim=1).contiguous()
    leaves = (("none", lid, -1), ("n/4096", lid, 2), ("n/64", lid, 1),
              ("root", roots, 0))
    forms = (("byte", 63, False, True), ("byte", 255, False, True),
             ("uint16", 1023, False, True), ("f64", 63, True, True),
             ("deferred", 63, False, False))
    fused = hasattr(lh, "leaf_plan")
    for max_bin in sorted({f[1] for f in forms}):
        ds = lgb.Dataset(X[:N], label=y[:N],
                         params=dict(cs.flagship_params(), max_bin=max_bin)
                         ).construct()
        Xr = cs.bins_t_of(ds).t().contiguous()
        B = int(ds._handle.num_bin_arr.max())
        del ds
        F = Xr.shape[1]
        bb = Xr.element_size()
        for form, mb, wide, finish in forms:
            if mb != max_bin:
                continue
            w3 = w32.double() if wide else w32
            exps = wk.fixed_point_exponents(w3)
            work = wk.list_workspace(N, 1, F, B, dev, wide, rowmajor=True)
            plan = lh.leaf_plan(F, B, wide) if fused else None
            for size, ids, leaf in leaves:
                leaf_t = torch.full((1,), leaf, dtype=torch.int32,
                                    device=dev)
                rows = int((ids == leaf).sum())

                def call(ids=ids, leaf_t=leaf_t, w3=w3, exps=exps,
                         work=work, B=B):
                    return lh.leaf_histogram(Xr, None, None, ids, leaf_t,
                                             None, B, w3=w3, exps=exps,
                                             work=work, finish=finish)
                h = call()
                torch.cuda.synchronize()
                wb = 24 if wide else 12
                alts = {}
                if fused and plan.fused and finish:
                    b4 = wk.hist_plan(F, N, B, 1, sms, False, wide)[:6]
                    variants = {"b4_chain": lambda: lh._launch(
                        Xr, w3, ids, leaf_t, B, exps, b4, work)}
                    for name, fn in variants.items():
                        assert torch.equal(fn(), h), name
                        alts[name] = replay_ms(fn)
                emit(b5=form, max_bin=max_bin, B=B, N=N, F=F, leaf=size,
                     rows=rows, ms=cs.time_ms(call), replay_ms=replay_ms(call),
                     plan=list(plan) if plan else None,
                     bound_ms=cs.bound(N * 4 + 4 + rows * (F * bb + wb)
                                       + F * B * wb, 3 * rows * F)[0],
                     hist_digest=digest(h), alternatives_replay_ms=alts,
                     device_us=device_us(call) if args.profile else None)
                del h
            del work
        if max_bin == 63:
            # the finish alone: one leaf's deferred sums to f32
            sums = lh.leaf_histogram(Xr, None, None, lid, torch.full(
                (1,), 1, dtype=torch.int32, device=dev), None, B, w3=w32,
                exps=wk.fixed_point_exponents(w32), finish=False).clone()
            one = torch.zeros(1, dtype=torch.int32, device=dev)
            ex = wk.fixed_point_exponents(w32)

            def fin():
                return wk.finish_hist(sums, one, ex)
            emit(finish=True, B=B, F=F, K=1, ms=cs.time_ms(fin),
                 replay_ms=replay_ms(fin),
                 bound_ms=cs.bound(sums.numel() * 12, 0)[0],
                 hist_digest=digest(fin()),
                 device_us=device_us(fin) if args.profile else None)
        del Xr
        torch.cuda.empty_cache()
    exact = dict(cs.flagship_params(), tpu_growth="exact",
                 tpu_histogram_mode="pallas")
    for label, p, n in (("exact", exact, N),
                        ("wide-exact", dict(exact, max_bin=1023),
                         args.train_rows),
                        ("dp-exact", dict(exact, tpu_use_dp=True),
                         args.train_rows)):
        emit(train=label, rows=n,
             **train_digest(cs, lgb, X, y, n, p, profile=args.profile))


# the device operations of a B5 call: the one-scan kernel and its
# conversion, or B4's chain (the exact grower launches no other
# histogram kernel)
B5_OPS = ("leaf_hist_kernel", "leaf_finish_kernel", "list_kernel",
          "hist_kernel", "finish_kernel", "Memset")


def iteration_profile(booster):
    """One more iteration of booster under torch.profiler: its device
    milliseconds, B5's (B5_OPS) with their count, and the six largest
    kernels'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        booster.update()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_time_total > 0]
    b5 = [e for e in ev if any(k in e.key for k in B5_OPS)]
    top = sorted(ev, key=lambda e: -e.device_time_total)[:6]
    return dict(
        device_ms=sum(e.device_time_total for e in ev) / 1e3,
        b5_ms=sum(e.device_time_total for e in b5) / 1e3,
        b5_ops=sum(e.count for e in b5),
        top={e.key[:60]: [e.device_time_total / 1e3, e.count] for e in top})


def train_digest(cs, lgb, X, y, n, params, rounds=5, profile=False):
    """{steady_it_s, train_s, text_digest} of `rounds` iterations of
    params on the first n rows (fused on the card), the text's
    drift_fingerprint= line dropped; with profile, iteration_profile's
    reading of one more iteration."""
    import torch
    ds = lgb.Dataset(X[:n], label=y[:n], params=params).construct()
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    t0 = time.perf_counter()
    booster = lgb.train(params, ds, rounds, callbacks=[stamp])
    torch.cuda.synchronize()
    text = "".join(ln for ln in booster.model_to_string().splitlines(
        keepends=True) if not ln.startswith("drift_fingerprint="))
    out = dict(steady_it_s=(len(stamps) - 1) / (stamps[-1] - stamps[0]),
               train_s=time.perf_counter() - t0,
               text_digest=hashlib.sha256(text.encode()).hexdigest()[:16])
    if profile:
        out["profile"] = iteration_profile(booster)
    del booster, ds
    torch.cuda.empty_cache()
    return out


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
    ap.add_argument("--b5", action="store_true",
                    help="time B5's forms and the finish alone")
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

    if args.b5:
        b5_cases(args, cs, lgb, lh, wk, X, y, emit)
        return
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
