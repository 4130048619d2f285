"""Images returned to host memory a second: calls completed x batch / window seconds."""


def read(ctx):
    h = ctx.host
    return h["units"] * h["batch"] / h["seconds"]
