"""Training on the port: AdamW, the train and eval steps, and the elastic
trainer."""
