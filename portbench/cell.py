"""One run of one cell: set-up, the measured window (traced or not), the
check against the reference, and the result line's fields."""

from __future__ import annotations

import copy
import statistics
import sys
import time
import types

import torch

from portbench import check, common, generator, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_matcher_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = v
    return out


def files(workload: str, bench: dict | None = None,
          overrides: dict | None = None) -> tuple[dict, dict]:
    """The cell's configuration and traffic mix, with ``overrides``
    ({"config": {...}, "traffic": {...}}) laid over them."""
    bench = bench or common.benchmark()
    spec = common.cell(bench, workload)
    over = overrides or {}
    return (merged(common.config(bench, spec["config"]), over.get("config")),
            merged(common.traffic(spec["traffic"]), over.get("traffic")))


def _where(device_type: str, n: int):
    from audio_matcher_tpu_torch.parallel.mesh import make_mesh

    if n == 1:
        return torch.device(device_type, 0) if device_type == "cuda" \
            else torch.device(device_type)
    return make_mesh(n, device_type)


def _peak_bytes(n: int) -> int:
    if not torch.cuda.is_available():
        return 0
    return max(torch.cuda.max_memory_allocated(i) for i in range(n))


def run(workload: str, seed: int, seconds: float, trace: bool,
        device_type: str = "cuda", bench: dict | None = None,
        overrides: dict | None = None, t_start: float | None = None,
        say=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """Run the cell → the result line as a dict (``check`` last).
    ``overrides``: {"config": {...}, "traffic": {...}} laid over the
    cell's files (tests run cells at small sizes on the CPU). What the
    traffic's driver's ``build``, ``window`` and ``release`` take and
    return: ``portbench/drivers/__init__.py``."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or common.benchmark()
    cfg, mix = files(workload, bench, overrides)
    n_cards = mix["devices"]
    gen_device = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.init()
    say(f"imports and the card ready {time.perf_counter() - t_start:.3f} s "
        f"in")
    traffic = generator.make(cfg, mix, seed, gen_device)
    check.free_device()
    say(f"traffic: {len(traffic.episodes)} episodes, {len(traffic.groups)} "
        f"groups a cycle, {len(traffic.queries)} queries, wire "
        f"{traffic.wire}, {time.perf_counter() - t_start:.3f} s in")
    if device_type == "cuda":
        for i in range(n_cards):
            torch.cuda.reset_peak_memory_stats(i)
    spans = tracing.Spans(trace)
    ctx = types.SimpleNamespace(cfg=cfg, mix=mix, traffic=traffic,
                                where=_where(device_type, n_cards),
                                seconds=seconds, spans=spans, traced=trace)
    drv = common.driver(mix["driver"])
    state = drv.build(ctx)
    if device_type == "cuda":
        for i in range(n_cards):
            torch.cuda.synchronize(i)
    spans.seconds.clear()
    setup_s = time.perf_counter() - t_start
    from audio_matcher_tpu_torch import _build

    say(f"set-up {setup_s:.4f} s, of it nvcc {_build.build_seconds():.4f} s")

    trace_info = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with spans("window"):
                rec = drv.window(state, ctx)
            if device_type == "cuda":
                for i in range(n_cards):
                    torch.cuda.synchronize(i)
    else:
        rec = drv.window(state, ctx)
    peak = _peak_bytes(n_cards) if device_type == "cuda" else 0
    say(f"window {rec['window_s']:.4f} s, {len(rec['items'])} items; "
        f"peak device memory {peak} bytes")
    drv.release(state)
    del state, ctx
    check.free_device()
    if trace:
        t_read = time.perf_counter()
        trace_info = tracing.read_trace(prof, n_cards)
        del prof
        say(f"trace: {trace_info['n_events']} device events, busy "
            f"{trace_info['busy_s']:.4f} of {trace_info['window_s']:.4f} s, "
            f"read in {time.perf_counter() - t_read:.3f} s")

    pairs = check.sample_pairs(traffic, mix, seed, rec["seen"])
    t_ref = time.perf_counter()
    refs = check.reference_peaks(traffic, cfg, pairs, gen_device)
    answers = [a for a in rec["answers"] if a[2] in pairs.get(a[1], ())]
    readings = check.compare([a[1:] for a in answers], refs)
    bad_items = {a[0] for a in answers
                 if [p[0] for p in a[3]] != [p[0] for p in refs[a[1], a[2]]]}
    ok, shown = check.judge(readings, cfg["limits"])
    say(f"reference: {sum(map(len, pairs.values()))} pairs of "
        f"{len(pairs)} episodes, {len(answers)} answers compared, "
        f"{time.perf_counter() - t_ref:.3f} s")

    record = types.SimpleNamespace(
        workload=workload, cfg=cfg, mix=mix, traffic=traffic,
        setup_s=setup_s, window_s=rec["window_s"], items=rec["items"],
        graph=rec["graph"], spans=dict(spans.seconds), trace=trace_info,
        n_cards=n_cards)
    metrics = {}
    for m in common.metrics_of(bench, workload, trace):
        value = common.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded after the window: {', '.join(bad)}")
    device = {"platform": "gpu" if device_type == "cuda" else device_type,
              "kind": (torch.cuda.get_device_name(0)
                       if device_type == "cuda" else device_type),
              "count": n_cards, "memory_peak_bytes": peak}
    if trace_info is not None:
        device["busy_s"] = trace_info["busy_s"]
        device["window_s"] = trace_info["window_s"]
    line = {"correct": ok, "attempted": len(rec["items"]),
            "failed": len(bad_items), "metrics": metrics, "device": device}
    if trace_info is not None:
        line["breakdown"] = {"device_ops": trace_info["device_ops"],
                             "idle_gaps": trace_info["idle_gaps"]}
    line["check"] = shown
    for name, v in shown.items():
        bound = ", ".join(f"{k} {v[k]!r}" for k in v if k != "value")
        say(f"check {name}: {v['value']!r} ({bound})")
    return line


def mean_ms(values) -> float | None:
    return 1e3 * statistics.fmean(values) if values else None
