"""Model-provider layer of the port: the prompt library for now; the
completion clients and the resolver come with the model providers."""
