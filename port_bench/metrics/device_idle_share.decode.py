"""The share of the traced decode window in which no operation ran on the
device: 1 - the union of its operations' intervals over the window, in
%."""


def read(trace, bench):
    busy = trace.busy_s()
    return 100.0 * (1.0 - busy / trace.window_s) if busy else None
