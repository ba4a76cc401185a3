"""Command-line support; the commands come with the CLI's port."""
