"""The benchmark's plain reference: ``render`` (the frame and its G-buffer)
and ``train`` (the SGD steps of the material bank). Plain PyTorch; imports
nothing of the program under test."""
