"""Share of the traced training window in which no kernel, copy or memset
ran on the device: the train step's host work (Python dispatch of
every op of the forward, backward and update) that the card waits
for."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
