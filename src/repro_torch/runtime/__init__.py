"""Runtime: the trainer's straggler monitor and elastic mesh shapes."""
