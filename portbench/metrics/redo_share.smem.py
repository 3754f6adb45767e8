"""The share of the window's query reads that rode the SMEM loop's redo
ladder (search/smem.STATS "redo" over "reads"), in %."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("smem_reads"):
        return None
    return 100.0 * c["smem_redo"] / c["smem_reads"]
