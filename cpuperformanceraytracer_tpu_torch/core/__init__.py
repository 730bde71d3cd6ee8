"""Vec3 math, hash RNGs, unit-vector samplers, color transforms."""
