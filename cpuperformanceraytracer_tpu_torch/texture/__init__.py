"""Env texture, equirect lookup, RGBE codec, procedural sky."""
