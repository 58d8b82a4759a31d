"""sortie_s (s): the window's sorties, each from the call of
app.run_stitch_application to the mosaic on disk and the card
synchronised, summed over the window and divided by their count."""


def read(ctx):
    return sum(u["seconds"] for u in ctx.units) / len(ctx.units)
