"""Launchers: the quantize, serve and train CLIs and the mesh factories
(the dry-run launcher is not ported yet)."""
