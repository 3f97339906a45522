"""The schema DSL (parse_schema, schema_to_string, validate) and the typed
schema builders."""
