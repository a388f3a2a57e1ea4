"""Cross-channel local response normalization (AlexNet §3.3)."""
