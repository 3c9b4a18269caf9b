"""Document parsers: bytes -> Parts."""
