"""The solver's glue (``M w - b``, dots, projections, the step): device
seconds of the traced stretch outside the ``dsc`` and ``wc`` ranges over
all its device seconds."""


def read(ctx):
    device_s = ctx["trace"]["device_s"]
    total = sum(device_s.values())
    if total <= 0:
        return None
    return 100.0 * device_s.get(None, 0.0) / total
