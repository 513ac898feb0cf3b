"""The plain reference: a reader of the snapshot format and the training
step in plain PyTorch. Imports nothing of the program (the port), of JAX
or of the JAX package, and takes nothing the program made."""
