"""Training: the train/eval steps, the flat-buffer AdamW, LR schedules."""
