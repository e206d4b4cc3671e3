"""Mean milliseconds a call spends in the engine's pack (RunStats.pack_s:
the host clock around pack_sw_pairs or Engine._phmm_pack)."""

from gxbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "pack_s")
