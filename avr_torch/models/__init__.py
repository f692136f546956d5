"""Field models: hash-grid encodings, MLPs and the complex IR field."""
