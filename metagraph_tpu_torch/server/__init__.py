"""The query server (``server_query``) and its stdlib client."""
