"""Sign-split rails of signed weights."""
