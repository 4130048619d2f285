"""Images trained a second: steps completed in the window x batch / window seconds
(the window closed by one torch.cuda.synchronize())."""


def read(ctx):
    h = ctx.host
    return h["units"] * h["batch"] / h["seconds"]
