"""The port's nodeflow: the DAG engine that runs the built-in search flow."""
