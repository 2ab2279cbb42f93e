"""Execution planes of the PyTorch port (port of parallel/): the engine
plane's captured chunk executables in :mod:`.compile_plan`."""
