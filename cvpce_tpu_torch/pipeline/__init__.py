"""Production pipeline: detection -> classification -> compliance."""
