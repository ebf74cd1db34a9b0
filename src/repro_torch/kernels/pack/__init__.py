"""d-grid → linear write-buffer pack kernel."""
