"""Training on one device: AdamW and the fault-tolerant train loop."""
