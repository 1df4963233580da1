"""States-dump reader."""
