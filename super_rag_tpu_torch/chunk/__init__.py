"""Structure-aware chunking of parsed documents."""
