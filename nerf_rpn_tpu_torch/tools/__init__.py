"""Host tools of the torch port: weight conversion, PLY / PNG dumps of the
drivers' outputs and the instant-ngp export of proposals."""
