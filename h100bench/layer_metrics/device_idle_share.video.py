"""Share of the traced serving window in which no kernel, copy or memset
ran on the device: the serving loop's host work (stacking, pinning,
uploads, the warm batch's synchronise, collecting ids) that the card waits
for."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
