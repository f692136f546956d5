"""How each kind of traffic drives the program: train and render."""
