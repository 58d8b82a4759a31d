"""seam_solve_mnodes (Mnodes): the solver's work, the grid nodes (h x w)
of every [GlobalCustom] seam solve span summed over a sortie, its mean
over the window, in millions: a smaller graph and a faster solve read
apart."""


def read(ctx):
    nodes = ctx.span_mean("GlobalCustom", {"seam solve done"}, "nodes")
    return None if nodes is None else nodes / 1e6
