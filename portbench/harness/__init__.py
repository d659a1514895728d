"""The benchmark's general code: registry, spans, trace reduction, checks."""
