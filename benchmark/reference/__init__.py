"""The plain reference: k-mer hashing, Count-Min counting and the novel
screen in plain PyTorch, from their definitions.  It imports nothing of
the system under test."""
