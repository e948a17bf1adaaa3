"""Media of the port: the image decoder the near-dup job's pHash reads."""
