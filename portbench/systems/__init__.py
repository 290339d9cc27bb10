"""How each configuration's system is driven and judged: one module a
``system`` named in ``configs/<config>.json``."""
