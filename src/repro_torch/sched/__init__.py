"""P2 scheduling quantities of the port (``problem``); the solvers are not
ported yet."""
