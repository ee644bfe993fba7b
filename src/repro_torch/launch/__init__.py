"""Launchers: the quantize and serve CLIs (the mesh, dry-run and train
launchers are not ported yet)."""
