"""Stage drivers, one module per model family, found by a configuration's
``family`` key."""
