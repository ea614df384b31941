"""Small shared pieces of the port (its own copies, see :mod:`.exceptions`)."""
