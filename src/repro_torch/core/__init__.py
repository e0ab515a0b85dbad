"""STD data types, plain SpMV executors, inspector, solver, registry, engine."""
