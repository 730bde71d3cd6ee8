"""Scene containers, builder, camera and named presets."""
