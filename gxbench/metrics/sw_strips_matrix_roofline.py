"""Percent of its roofline that sw_strips_kernel (genomax_torch/csrc/
sw_strips.cu) reached over the traced window on the cells the program
counted under ``cells.strips``, whatever other kernels ran beside it
(``sw_long_matrix_roofline.route_roofline_pct``)."""

from gxbench.metrics.sw_long_matrix_roofline import route_roofline_pct


def read(ctx):
    return route_roofline_pct(ctx, "strips", "sw_strips_kernel")
