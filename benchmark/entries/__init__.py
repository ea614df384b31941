"""Entry kinds: one file per kind of call the window drives."""
