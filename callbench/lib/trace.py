"""Device activity of a torch.profiler Chrome trace.

The arithmetic of the program's bench_torch.device_activity, copied: the
union of the device's own rows (kernels, copies, memsets) over the trace's
window (first to last recorded event), the kernels with the most device
time and the longest gaps with no device row."""

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(trace_path, top=10, n_gaps=10):
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not events:
        return None
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in DEVICE_CATS)
    if not dev:
        return None
    merged = [list(dev[0])]
    for s, e in dev[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1] - lo)
            for i in range(len(merged) - 1)]
    gaps += [(merged[0][0] - lo, 0.0), (hi - merged[-1][1], merged[-1][1] - lo)]
    gaps.sort(reverse=True)
    by_name = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            ent = by_name.setdefault(e.get("name", "?"), [0.0, 0])
            ent[0] += float(e["dur"])
            ent[1] += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # what the host was doing through each long gap: the host operator
    # that covers most of it, the shorter one on a tie (the profiler's own
    # span covers everything and names nothing)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
            for e in events if e.get("cat") not in DEVICE_CATS
            and not e.get("name", "").startswith("PyTorch Profiler")]
    named = []
    for g, at in gaps[:n_gaps]:
        g0, g1 = lo + at, lo + at + g
        best, name = (0.0, 0.0), "no host operator"
        for s, e, n in host:
            key = (min(e, g1) - max(s, g0), s - e)
            if key[0] > 0 and key > best:
                best, name = key, n
        named.append([name[:80], g / 1e6])
    return {
        "window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
        "device_ops": [[n[:80], v[0] / 1e6] for n, v in ops[:top]],
        "idle_gaps": named,
    }
