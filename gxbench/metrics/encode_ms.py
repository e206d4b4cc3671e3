"""Mean milliseconds a traced call spends encoding residues to the
matrix's codes and checking them: the program's ``pack.encode`` spans
(inside ``pack`` on the bucket route, inside each long tile's
``pack.fill`` on the offload)."""

from gxbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "pack.encode")
