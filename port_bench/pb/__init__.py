"""The port's benchmark: one run of one cell (`cell`), what it reads by
name (`spec`), the traffic generator (`traffic`), the system under test
(`program`, the only module that imports the port), the trace reduction
(`trace`, `intervals`), the operation count and peaks (`opcount`), and
the plain reference and comparison that decide `correct` (`task`,
`reference`, `editdist`, `check`)."""
