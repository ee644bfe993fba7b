"""Runtime: the trainer's straggler monitor (elastic membership is not
ported yet)."""
