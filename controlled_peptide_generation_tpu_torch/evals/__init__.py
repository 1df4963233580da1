"""Physicochemical peptide evaluation."""
