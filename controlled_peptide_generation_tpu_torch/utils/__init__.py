"""Device selection and numeric settings."""
