"""Host-side text frontend."""
