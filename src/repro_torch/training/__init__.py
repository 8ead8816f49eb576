"""Training: AdamW with optional int8 moments, LR schedules, the train
step and the trainer loop (the twins of ``repro.training``)."""
