"""The plain reference: the sparse GP's evidence, its gradient and its
predictors in plain PyTorch, written from the model's equations and
independent of the program (it imports nothing of it)."""
