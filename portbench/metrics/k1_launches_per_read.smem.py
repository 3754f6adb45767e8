"""K1 launches a query read: the port's launch counter
(ops/rank_cuda.LAUNCHES) over the reads smem_all searched
(search/smem.STATS["reads"]), both counted over the window."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("smem_reads"):
        return None
    return c["k1_launches"] / c["smem_reads"]
