"""Engine package of the port: rule DSL, enumeration, ensemble rounds."""
