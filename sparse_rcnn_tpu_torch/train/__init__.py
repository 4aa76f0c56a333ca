"""Training and evaluation of the port: the train and eval steps, evaluation
over a split, checkpoints and the training CLI."""
