"""setup_s: seconds from the process's start until the window could open
(imports, the card's start, the model drawn and packed, the kernel built
on a checkout's first run, the traffic's shapes warmed)."""


def read(ctx):
    return ctx["setup_s"]
