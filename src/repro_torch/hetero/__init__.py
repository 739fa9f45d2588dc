"""Client heterogeneity of the port: per-client resource profiles
(`profiles`).  The async runtime that consumes them is a later slice."""
