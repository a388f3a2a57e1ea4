"""Data of the port: synthetic streams, preprocessing and loaders."""
