"""Core math: RNG, vector helpers, image IO."""
