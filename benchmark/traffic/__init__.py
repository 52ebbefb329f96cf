"""The inputs of a cell, drawn on the device from the seed: genome,
variants, trio and reads."""
