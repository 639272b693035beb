"""Share of the network's slabs that replayed a CUDA graph: Σ net_graph_slabs
over Σ net_slabs (counters stamped by PileupNet.forward_slabs inside a
chunk's build; the fused pass, its rerun and its escapes) over the
window's fused-attempted chunks, in %. Nothing to read without fused
chunks, without the two columns or without a slab."""


def read(ctx):
    rows = [r for job in ctx["jobs"] for rows in job.get("joblog_rows", [])
            for r in rows if r.get("route") in ("fused", "fallback")]
    if not rows or any("net_slabs" not in r or "net_graph_slabs" not in r
                       for r in rows):
        return None
    slabs = sum(int(r["net_slabs"]) for r in rows)
    if not slabs:
        return None
    return 100.0 * sum(int(r["net_graph_slabs"]) for r in rows) / slabs
