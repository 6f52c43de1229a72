"""setup_s: seconds from the run's start (the harness module's first
line) to the window's first request: weights made on the card, the
server and its engine built, the engine's warmup (kernel builds and graph
captures on a checkout's first run), two warm requests."""


def read(run):
    return run["setup_s"]
