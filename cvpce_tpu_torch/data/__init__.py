"""Host-side data: image transforms and synthetic planogram scenes."""
