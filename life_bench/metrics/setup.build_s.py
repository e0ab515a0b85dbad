"""The engine's constructor (inspector, sorts, tile plans, layout
encoders, uploads) on the host clock, from the harness, ending in a
synchronise."""


def read(ctx):
    return ctx["build_s"]
